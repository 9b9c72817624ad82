"""Port parity for the whole slice: ABCSMC(...).new(...).run() on the CPU
against the JAX package's run of the same configuration.

The two packages draw different random numbers (torch generators against
threefry), so whole runs are compared statistically, each tolerance with
its reason below.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gaussian as jgauss  # noqa: E402
from pyabc_tpu.models import lotka_volterra as jlv  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels.scale_reduce import weight_update_plain  # noqa: E402,E501
from pyabc_tpu_torch.models import gaussian, lotka_volterra  # noqa: E402

torch.set_num_threads(1)

X_OBS, POP, GENS = 1.0, 200, 4
SEEDS = (1, 2, 3, 4)


def _posterior_mean(h):
    df, w = h.get_distribution()
    return float(np.sum(df["theta"] * w))


def _trail(h):
    return np.asarray(h.get_all_populations()["epsilon"][1:])


@pytest.fixture(scope="module")
def toy_runs():
    """The Gaussian toy at pop 200 for GENS generations, one run per seed
    in each package."""
    ports, hps, hjs = [], [], []
    for seed in SEEDS:
        port = tpt.ABCSMC(gaussian.make_mean_only_model(0.5),
                          gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                          population_size=POP, eps=tpt.MedianEpsilon(),
                          seed=seed, device="cpu")
        port.new("sqlite://", {"x": X_OBS})
        hps.append(port.run(max_nr_populations=GENS))
        ports.append(port)
        ref = jpt.ABCSMC(jgauss.make_mean_only_model(0.5),
                         jgauss.mean_only_prior(), jpt.PNormDistance(p=2),
                         population_size=POP, eps=jpt.MedianEpsilon(),
                         seed=seed)
        ref.new("sqlite://", {"x": X_OBS})
        hjs.append(ref.run(max_nr_populations=GENS))
    return ports, hps, hjs


def test_gaussian_toy_posterior(toy_runs):
    _ports, hps, hjs = toy_runs
    assert all(h.n_populations == GENS for h in hps + hjs)
    mu_true, _sd = gaussian.conjugate_posterior(X_OBS, noise_sd=0.5)
    mps = [_posterior_mean(h) for h in hps]
    mjs = [_posterior_mean(h) for h in hjs]
    # one run at pop 200 after 4 generations: the weighted mean's Monte
    # Carlo error (sd 0.45 / sqrt(ESS ~ 150) ~ 0.04) plus the ABC bias at
    # the last epsilon stay inside 0.15; the seed averages much closer
    assert all(abs(m - mu_true) < 0.15 for m in mps)
    assert abs(np.mean(mps) - mu_true) < 0.1
    assert abs(np.mean(mps) - np.mean(mjs)) < 0.15


def test_gaussian_toy_epsilon_trail(toy_runs):
    ports, hps, hjs = toy_runs
    ep = np.exp(np.mean([np.log(_trail(h)) for h in hps], axis=0))
    ej = np.exp(np.mean([np.log(_trail(h)) for h in hjs], axis=0))
    # each epsilon is the median of ~200 accepted distances (about 8%
    # relative error) and the errors compound along the trail; the
    # geometric mean over four seeds keeps the packages within 25%
    np.testing.assert_allclose(ep, ej, rtol=0.25)
    for port, h in zip(ports, hps):
        trail = _trail(h)
        assert np.all(np.diff(trail) <= 0)
        # one counter read per round (calibration included) plus one
        # packed fetch for the single chunk
        rounds = sum(g["rounds"] for g in port.generation_log)
        assert port.sync_ledger.summary()["by_kind"] == {
            "round_counters": rounds + 1, "chunk_fetch": 1}
        # the host mirror of the quantile epsilon matches the stored trail
        assert [port.eps(t) for t in range(GENS)] == list(trail)


def _lv_config2_trails(seed, pop, gens):
    """Epsilon trails of LV config 2 (AdaptivePNormDistance(p=2),
    MedianEpsilon) in the port and in the JAX package, on the JAX
    package's observation; also the port's ABCSMC."""
    obs = jlv.observed_data(seed=0)
    port = tpt.ABCSMC(lotka_volterra.make_lv_model(),
                      lotka_volterra.default_prior(),
                      tpt.AdaptivePNormDistance(p=2), population_size=pop,
                      eps=tpt.MedianEpsilon(), seed=seed, device="cpu")
    port.new("sqlite://", obs, store_sum_stats=False)
    hp = port.run(max_nr_populations=gens)
    ref = jpt.ABCSMC(jlv.make_lv_model(), jlv.default_prior(),
                     jpt.AdaptivePNormDistance(p=2), population_size=pop,
                     eps=jpt.MedianEpsilon(), seed=seed)
    ref.new("sqlite://", obs, store_sum_stats=False)
    hj = ref.run(max_nr_populations=gens)
    return _trail(hp), _trail(hj), port


def test_lotka_volterra_adaptive_trail_tracks_jax():
    """LV config 2 at pop 200: the port's epsilon trail follows the JAX
    package's, and where the port's rises between generations (each
    adaptive epsilon is a quantile in a newly weighted distance) the JAX
    package's rises too, on some of the same seeds."""
    runs = [_lv_config2_trails(seed, POP, 5) for seed in SEEDS]
    ep = np.stack([r[0] for r in runs])
    ej = np.stack([r[1] for r in runs])
    # same observation, different random streams: medians of 200
    # distances agree to ~10%, well inside 25%
    np.testing.assert_allclose(ep, ej, rtol=0.25)
    port_rises = set(np.nonzero((np.diff(ep, axis=1) > 0).any(0))[0])
    jax_rises = set(np.nonzero((np.diff(ej, axis=1) > 0).any(0))[0])
    assert port_rises and port_rises <= jax_rises
    # the adaptive weights were refit each generation on the device and
    # mirrored to the host, normalized to mean 1
    w = runs[0][2].distance_function.weights
    assert sorted(w) == list(range(6))
    for t in w:
        np.testing.assert_allclose(w[t].mean(), 1.0, rtol=1e-5)


def test_lotka_volterra_fixed_distance_epsilons_do_not_increase():
    obs = lotka_volterra.observed_data(seed=0)
    abc = tpt.ABCSMC(lotka_volterra.make_lv_model(),
                     lotka_volterra.default_prior(), tpt.PNormDistance(p=2),
                     population_size=100, eps=tpt.MedianEpsilon(), seed=2,
                     device="cpu", fused_generations=2)
    abc.new("sqlite://", obs)
    h = abc.run(max_nr_populations=4)
    eps = np.asarray(h.get_all_populations()["epsilon"][1:])
    assert len(eps) == 4 and np.all(np.diff(eps) <= 0)


def test_calibration_weights_match_jax_on_one_sample():
    """The in-kernel calibration step (scale over the masked calibration
    reservoir -> 1/scale weights -> quantile epsilon) on an identical
    sample: LV rows from the port's simulator fed to both packages."""
    rng = np.random.default_rng(4)
    n_cap, n_cal = 256, 200
    model, prior = lotka_volterra.make_lv_model(), \
        lotka_volterra.default_prior()
    theta = torch.from_numpy(np.stack(
        [rng.uniform(0, 3, n_cap), rng.uniform(0, 0.5, n_cap),
         rng.uniform(0, 3, n_cap), rng.uniform(0, 0.3, n_cap)],
        1).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(
        (n_cap, 2, 20)).astype(np.float32))
    ss = model.simulate_with_noise(theta, noise)
    obs = lotka_volterra.observed_data(seed=0)
    x0 = np.concatenate([obs["pred"], obs["prey"]]).astype(np.float32)
    mask = np.arange(n_cap) < n_cal
    jd = jpt.AdaptivePNormDistance(p=2)
    spec = jpt.SumStatSpec(obs)
    j_w = jd.device_weight_update()(jd.device_record_reduce(spec)(
        jnp.asarray(ss.numpy()), jnp.asarray(mask), jnp.asarray(x0)))
    j_d = np.asarray([jd.device_fn(spec)(jnp.asarray(r), jnp.asarray(x0),
                                         j_w) for r in ss.numpy()[:n_cal]])
    td = tpt.AdaptivePNormDistance(p=2)
    t_w = weight_update_plain(
        td.scale(ss, torch.from_numpy(mask), torch.from_numpy(x0)),
        td.max_weight_ratio, td.normalize_weights)
    # float32 masked medians in another order: rel 1e-5
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), rtol=1e-5)
    t_d = td.rows(ss[:n_cal], torch.from_numpy(x0), t_w).numpy()
    np.testing.assert_allclose(t_d, j_d, rtol=1e-4)
    np.testing.assert_allclose(np.median(t_d), np.median(j_d), rtol=1e-4)


if __name__ == "__main__":
    # LV config 2 at its full size (pop 1000, 10 generations) on the CPU:
    # both packages' epsilon trails and the generations where each rises.
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slice.py
    for seed in SEEDS:
        tp, tj, _ = _lv_config2_trails(seed, 1000, 10)
        for name, tr in (("port", tp), ("jax ", tj)):
            print(f"seed {seed} {name} eps {np.round(tr, 3).tolist()} "
                  f"rises after generation "
                  f"{np.nonzero(np.diff(tr) > 0)[0].tolist()}", flush=True)
