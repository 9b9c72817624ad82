"""Whole runs with linear learned summary statistics: the port against the
JAX package's own fused runs on the CPU.

The Fearnhead-Prangle Gaussian model of ``tests/test_fused_sumstat.py``
(two informative statistics, four of pure noise) under
``PNormDistance`` and ``AdaptivePNormDistance`` with a
``PredictorSumstat(LinearPredictor())``: the posterior mean against the
analytic one and the JAX package's, and the generations the predictor
was fitted at (the seed fit after generation 0, then each chunk's
boundary) equal to the JAX package's. Then the network SIR at a small
shape (2 patches, 8 observations: S 16 in 4 segments) over three seeds:
the epsilon trails against the JAX package's, early reject on and off
bit-identical, History rows S wide at generation 0 and C' wide after, and
the db read back by the JAX package's ``History``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import sir as jsir  # noqa: E402
from pyabc_tpu.storage.history import History as JHistory  # noqa: E402
from pyabc_tpu.sumstat import device as jdevice  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.inference import smc as tsmc  # noqa: E402
from pyabc_tpu_torch.models import sir as tsir  # noqa: E402

torch.set_num_threads(1)

NOISE_SD = 0.3
POST_MU = 1.0 * (2 / NOISE_SD**2) / (1.0 + 2 / NOISE_SD**2)
#: the JAX suite's rules (test_fused_sumstat.py): the posterior mean
#: within 0.25 of the analytic one, two estimates within 0.3 of each
#: other; epsilon trails within test_torch_aggregate_runs.py's 0.2
#: relative (seed means)
MU_ABS, MU_PAIR, EPS_RTOL = 0.25, 0.3, 0.2
FP_OBS = {"sig": np.asarray([1.0, 1.0]), "noise": np.zeros(4)}


def _jax_fp():
    @jpt.JaxModel.from_function(["theta"], name="fp")
    def model(key, theta):
        k1, k2 = jax.random.split(key)
        sig = theta[0] + NOISE_SD * jax.random.normal(k1, (2,))
        noise = 5.0 * jax.random.normal(k2, (4,))
        return {"sig": sig, "noise": noise}

    return model


def _port_fp():
    def sim(theta, gen):
        z = torch.randn(theta.shape[0], 6, generator=gen,
                        device=theta.device)
        return {"sig": theta[:, :1] + NOISE_SD * z[:, :2],
                "noise": 5.0 * z[:, 2:]}

    return tpt.TorchModel(sim, ["theta"], name="fp")


def _fits(monkeypatch, pkg):
    """Record the generations each boundary fit is mirrored for."""
    seen = []
    mod = jdevice if pkg is jpt else tsmc
    real = mod.mirror_fitted_params

    def record(dist, ssp, t):
        seen.append(int(t))
        return real(dist, ssp, t)

    monkeypatch.setattr(mod, "mirror_fitted_params", record)
    return seen


def _fp_run(pkg, dist, seed):
    prior = pkg.Distribution(theta=pkg.RV("norm", 0.0, 1.0))
    extra = {} if pkg is jpt else {"device": "cpu"}
    abc = pkg.ABCSMC(_jax_fp() if pkg is jpt else _port_fp(), prior, dist,
                     population_size=400, eps=pkg.MedianEpsilon(),
                     seed=seed, fused_generations=3, **extra)
    abc.new("sqlite://", FP_OBS)
    h = abc.run(max_nr_populations=8)
    df, w = h.get_distribution(0, h.max_t)
    return h, float(np.sum(df["theta"] * w))


@pytest.mark.parametrize("kind", ["PNormDistance", "AdaptivePNormDistance"])
def test_fearnhead_prangle_matches_jax(kind, monkeypatch):
    runs = {}
    for pkg in (jpt, tpt):
        fits = _fits(monkeypatch, pkg)
        dist = getattr(pkg, kind)(p=2, sumstat=pkg.PredictorSumstat(
            pkg.LinearPredictor()))
        h, mu = _fp_run(pkg, dist, seed=31)
        assert h.n_populations == 8
        runs[pkg] = (mu, [1] + fits, dist.sumstat._last_fit_t)
    (jmu, jfits, jlast), (tmu, tfits, tlast) = runs[jpt], runs[tpt]
    assert tfits == jfits and tlast == jlast == jfits[-1]
    assert abs(tmu - POST_MU) < MU_ABS and abs(jmu - POST_MU) < MU_ABS
    assert abs(tmu - jmu) < MU_PAIR


SIR_SHAPE = dict(n_patches=2, n_obs=8)
SIR_SEEDS = (11, 12, 13)


def _sir_run(pkg, seed, early="auto", db="sqlite://"):
    mod = jsir if pkg is jpt else tsir
    extra = {} if pkg is jpt else {"device": "cpu"}
    dist = pkg.PNormDistance(p=2, sumstat=pkg.PredictorSumstat(
        pkg.LinearPredictor(alpha=1.0)))
    abc = pkg.ABCSMC(mod.make_network_sir_model(**SIR_SHAPE),
                     mod.network_sir_prior(), dist, population_size=256,
                     eps=pkg.MedianEpsilon(), seed=seed,
                     fused_generations=2, early_reject=early, **extra)
    abc.new(db, mod.observed_network_sir(**SIR_SHAPE))
    return abc, abc.run(max_nr_populations=4)


def _eps(h):
    return h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()


def _arrays(h):
    out = {"eps": _eps(h)}
    for t in range(h.n_populations):
        df, w = h.get_distribution(0, t)
        out[f"theta_{t}"] = df.to_numpy()
        out[f"w_{t}"] = np.asarray(w)
        out[f"d_{t}"] = h.get_weighted_distances(t)["distance"].to_numpy()
        out[f"ss_{t}"] = h.get_weighted_sum_stats(t)[1]
    return out


@pytest.mark.parametrize("seed", SIR_SEEDS)
def test_network_sir_early_reject_on_off_bit_identical(seed, tmp_path):
    """The transformed bound changes no result: populations, weights,
    distances, statistics and the trail bit-identical on and off; every
    slot resolves; History rows raw at generation 0, learned after, read
    back by the JAX package."""
    db = f"sqlite:///{tmp_path / 'sir.db'}"
    abc_on, h_on = _sir_run(tpt, seed, "auto", db)
    _abc, h_off = _sir_run(tpt, seed, False)
    assert h_on.n_populations == h_off.n_populations == 4
    a, b = _arrays(h_on), _arrays(h_off)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    tel = [h_on.get_telemetry(t) for t in range(1, 4)]
    assert all(x["seg_resolved"] > 0 for x in tel)
    assert "retired_early" not in h_on.get_telemetry(0)
    assert a["ss_0"].shape[1] == 16
    assert all(a[f"ss_{t}"].shape[1] == 2 for t in range(1, 4))
    assert h_on.get_telemetry(0)["sumstat"]["dim_reduced"] == 2
    jh = JHistory(db)
    assert jh.n_populations == 4
    np.testing.assert_array_equal(
        jh.get_weighted_distances(3)["distance"].to_numpy(), a["d_3"])
    # one counter read a round, one fetch a chunk (generation 0's own,
    # then two chunks of two), no other read
    by_kind = abc_on.sync_ledger.summary()["by_kind"]
    assert set(by_kind) == {"round_counters", "chunk_fetch"}
    assert by_kind["chunk_fetch"] == 3


def test_network_sir_trails_match_jax():
    trails, ref = [], []
    for seed in SIR_SEEDS:
        _a, h = _sir_run(tpt, seed)
        _j, jh = _sir_run(jpt, seed)
        assert h.n_populations == jh.n_populations == 4
        trails.append(_eps(h))
        ref.append(_eps(jh))
    np.testing.assert_allclose(np.mean(trails, 0), np.mean(ref, 0),
                               rtol=EPS_RTOL)


#: learned statistics beside the port's other run options, each against
#: the JAX package's run of the same configuration
COMBOS = {
    "LocalTransition": lambda pkg: dict(
        transitions=pkg.LocalTransition(k_fraction=0.25),
        early_reject=False),
    "ListPopulationSize": lambda pkg: dict(
        population_size=pkg.ListPopulationSize([300, 400, 200, 300])),
}


@pytest.mark.parametrize("combo", sorted(COMBOS))
def test_network_sir_learned_beside_other_options(combo):
    """Each generation's n is the fit's (the kept rows follow the
    generation's n), the transform is refit at each chunk's boundary, and
    the epsilon trail stays within EPS_RTOL of the JAX package's."""
    trails = {}
    for pkg in (jpt, tpt):
        mod = jsir if pkg is jpt else tsir
        extra = {} if pkg is jpt else {"device": "cpu"}
        kw = {"population_size": 256, **COMBOS[combo](pkg)}
        abc = pkg.ABCSMC(mod.make_network_sir_model(**SIR_SHAPE),
                         mod.network_sir_prior(),
                         pkg.PNormDistance(p=2, sumstat=pkg.PredictorSumstat(
                             pkg.LinearPredictor(alpha=1.0))),
                         eps=pkg.MedianEpsilon(), seed=11,
                         fused_generations=2, **kw, **extra)
        abc.new("sqlite://", mod.observed_network_sir(**SIR_SHAPE))
        h = abc.run(max_nr_populations=4)
        assert h.n_populations == 4
        assert abc.distance_function.sumstat._last_fit_t == 4
        trails[pkg] = _eps(h)
        if pkg is tpt:
            ns = h.get_nr_particles_per_population().to_numpy()[1:]
            want = [300, 400, 200, 300] if combo == "ListPopulationSize" \
                else [256] * 4
            assert ns.tolist() == want
            refits = [t for t in range(4)
                      if h.get_telemetry(t).get("sumstat_refit")]
            assert refits == [2, 3]
    np.testing.assert_allclose(trails[tpt], trails[jpt], rtol=EPS_RTOL)


#: the accuracy setting of tests/test_sumstat_device.py:497-540: noise 30
#: in the network SIR at 8 patches x 16 observations and in its
#: observation, pop 256, 8 generations, chunks of 2
ACC = dict(n_patches=8, n_obs=16, noise_sd=30.0)


def accuracy_rmse(pkg, seed: int, learned: bool) -> float:
    """The posterior-mean RMSE against TRUE_PARS of one run of the
    accuracy setting (the identity or the learned statistic)."""
    mod = jsir if pkg is jpt else tsir
    extra = {} if pkg is jpt else {"device": "cpu"}
    dist = (pkg.PNormDistance(p=2, sumstat=pkg.PredictorSumstat(
        pkg.LinearPredictor(alpha=1.0))) if learned
        else pkg.PNormDistance(p=2))
    abc = pkg.ABCSMC(mod.make_network_sir_model(**ACC),
                     mod.network_sir_prior(), dist, population_size=256,
                     eps=pkg.MedianEpsilon(), seed=seed,
                     fused_generations=2, **extra)
    abc.new("sqlite://", mod.observed_network_sir(**ACC))
    h = abc.run(max_nr_populations=8)
    df, w = h.get_distribution(0, h.max_t)
    err = [float(np.sum(df[k] * w)) - v for k, v in mod.TRUE_PARS.items()]
    return float(np.sqrt(np.mean(np.square(err))))


if __name__ == "__main__":
    # Both packages over chip_smoke.py's accuracy seeds (19..34, CPU, a few
    # minutes): per seed the identity's and the learned statistic's RMSE,
    # then the seed mean and sd of the learned RMSE and of the gap (learned
    # minus identity), and the seeds meeting the JAX suite's rule (at most
    # the identity's + 0.02). chip_smoke.py's accuracy check holds the
    # card's learned mean and gap mean to the JAX package's (LS_ACC_JAX).
    #   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_sumstat_runs.py
    seeds = range(19, 35)
    for pkg in (jpt, tpt):
        ident = np.array([accuracy_rmse(pkg, s, False) for s in seeds])
        lin = np.array([accuracy_rmse(pkg, s, True) for s in seeds])
        gap = lin - ident
        print(f"{pkg.__name__}: identity RMSE per seed "
              f"{[round(float(v), 4) for v in ident]}")
        print(f"{pkg.__name__}: learned RMSE per seed "
              f"{[round(float(v), 4) for v in lin]}")
        print(f"{pkg.__name__}: seeds {seeds[0]}-{seeds[-1]}: learned mean "
              f"{lin.mean():.4f} sd {lin.std(ddof=1):.4f}; identity mean "
              f"{ident.mean():.4f} sd {ident.std(ddof=1):.4f}; gap mean "
              f"{gap.mean():.4f} sd {gap.std(ddof=1):.4f}; the rule met on "
              f"{int((gap <= 0.02).sum())} of {len(gap)} seeds")
