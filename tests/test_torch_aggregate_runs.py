"""Whole runs with aggregated distances and weight schedules: the port
against the JAX package's own fused runs on the CPU.

The configurations are the JAX suite's (``tests/test_fused.py``): the
Gaussian toy under a fixed and an adaptive aggregate (span and
standard_deviation), the two-statistic model under an aggregated schedule
and under a p-norm schedule; then the birth-death model of config 3 at a
small population under the aggregated pair of ``test_segment.py:114`` with
early reject on and off, and a port-written History read back by the JAX
package's ``History``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.distance import scale as jscale  # noqa: E402
from pyabc_tpu.models import gillespie as jg  # noqa: E402
from pyabc_tpu.storage.history import History as JHistory  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402

torch.set_num_threads(1)

NOISE_SD, X_OBS = 0.5, 1.0
POST_MU = gaussian.conjugate_posterior(X_OBS, noise_sd=NOISE_SD)[0]
#: the JAX suite's rules (test_fused.py:605-690): posterior mean within
#: 0.3 of the analytic one, epsilon trails within 0.2 (fixed) / 0.25
#: (adaptive) relative, per-generation weights within 0.35 relative
MU_ABS, EPS_RTOL, EPS_RTOL_ADAPTIVE, W_RTOL = 0.3, 0.2, 0.25, 0.35
#: stored distances recomputed under each generation's weights from the
#: float32-fetched statistics (test_fused.py:271)
SCHED_RTOL, SCHED_ATOL = 2e-3, 1e-5


def _jax_gauss():
    @jpt.JaxModel.from_function(["theta"], name="gauss")
    def model(key, theta):
        return {"x": theta[0] + NOISE_SD * jax.random.normal(key)}

    return model


def _port_two_stat():
    def sim(theta, gen):
        z = torch.randn(2, theta.shape[0], generator=gen,
                        device=theta.device)
        return {"a": theta[:, 0] + 0.5 * z[0],
                "b": 2.0 * theta[:, 0] + 1.0 * z[1]}

    return tpt.TorchModel(sim, ["theta"], name="gauss2")


def _run(pkg, dist, *, seed, pop, gens, model=None, obs=None, **kw):
    prior = pkg.Distribution(theta=pkg.RV("norm", 0.0, 1.0))
    if model is None:
        model = (_jax_gauss() if pkg is jpt else
                 gaussian.make_mean_only_model(noise_sd=NOISE_SD))
    extra = {} if pkg is jpt else {"device": "cpu"}
    abc = pkg.ABCSMC(model, prior, dist, population_size=pop,
                     eps=pkg.MedianEpsilon(), seed=seed, **kw, **extra)
    abc.new("sqlite://", obs or {"x": X_OBS})
    return abc, abc.run(max_nr_populations=gens)


def _mean(h):
    df, w = h.get_distribution(0, h.max_t)
    return float(np.sum(df["theta"] * w))


def _eps(h):
    return h.get_all_populations().query("t >= 1")["epsilon"].to_numpy()


def test_fixed_aggregate_matches_jax():
    """test_fused.py:605-645: AggregatedDistance([p 2, p 1], [1, 0.5])."""
    def make(pkg):
        return pkg.AggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)],
            weights=[1.0, 0.5])

    _ja, jh = _run(jpt, make(jpt), seed=47, pop=300, gens=5,
                   fused_generations=4)
    assert jh.get_telemetry(2).get("fused_chunk")
    abc, h = _run(tpt, make(tpt), seed=47, pop=300, gens=5,
                  fused_generations=4)
    assert h.n_populations == jh.n_populations
    np.testing.assert_allclose(_eps(h), _eps(jh), rtol=EPS_RTOL)
    assert _mean(h) == pytest.approx(POST_MU, abs=MU_ABS)
    assert _mean(jh) == pytest.approx(POST_MU, abs=MU_ABS)
    # one counter read a round, one fetch a chunk (two chunks)
    by_kind = abc.sync_ledger.summary()["by_kind"]
    assert by_kind["chunk_fetch"] == 2
    assert all(g["syncs"] == g["rounds"] for g in abc.generation_log)


#: the adaptive runs' seeds: the span of a few hundred records is a noisy
#: scale, so the packages' trails (different random streams) are compared
#: as means over seeds, each seed's weights on their own
ADAPTIVE_SEEDS = (53, 54, 55)


@pytest.mark.parametrize("scale", ["span", "standard_deviation"])
def test_adaptive_aggregate_matches_jax(scale):
    """test_fused.py:647-690: AdaptiveAggregatedDistance([p 2, p 1]) with
    the default span and with standard_deviation; the weights refit each
    generation (and at calibration) mirror into the host dict."""
    fns = {"span": (None, None),
           "standard_deviation": (jscale.standard_deviation,
                                  tscale.standard_deviation)}[scale]

    def make(pkg, fn):
        kw = {} if fn is None else {"scale_function": fn}
        return pkg.AdaptiveAggregatedDistance(
            [pkg.PNormDistance(p=2), pkg.PNormDistance(p=1)], **kw)

    trails, ref_trails = [], []
    for seed in ADAPTIVE_SEEDS:
        ja, jh = _run(jpt, make(jpt, fns[0]), seed=seed, pop=300, gens=5,
                      fused_generations=4)
        assert jh.get_telemetry(2).get("fused_chunk")
        abc, h = _run(tpt, make(tpt, fns[1]), seed=seed, pop=300, gens=5,
                      fused_generations=4)
        assert h.n_populations == jh.n_populations
        trails.append(_eps(h))
        ref_trails.append(_eps(jh))
        w_t = abc.distance_function.weights
        w_j = ja.distance_function.weights
        shared = sorted(set(w_t) & set(w_j) - {-1})
        assert len(shared) >= 5  # the calibration's and one a generation
        for t in shared:
            np.testing.assert_allclose(np.asarray(w_t[t]),
                                       np.asarray(w_j[t]), rtol=W_RTOL)
        assert _mean(h) == pytest.approx(POST_MU, abs=MU_ABS)
    np.testing.assert_allclose(np.mean(trails, 0), np.mean(ref_trails, 0),
                               rtol=EPS_RTOL_ADAPTIVE)


def _check_stored_distances_match_schedule(h, dist, obs):
    """The JAX suite's rule: every persisted distance equals the host
    distance at THAT generation (the kernel used the schedule's row)."""
    for t in range(h.max_t + 1):
        wd = np.sort(h.get_weighted_distances(t)["distance"].to_numpy())
        _w, stats = h.get_weighted_sum_stats(t)
        recomputed = np.sort([
            dist({"a": float(s[0]), "b": float(s[1])}, obs, t)
            for s in stats])
        np.testing.assert_allclose(wd, recomputed, rtol=SCHED_RTOL,
                                   atol=SCHED_ATOL)


SCHEDULES = {
    "aggregated": lambda pkg: pkg.AggregatedDistance(
        [pkg.PNormDistance(p=2, weights={0: {"a": 1.0, "b": 0.0},
                                         3: {"a": 2.0, "b": 0.0}}),
         pkg.PNormDistance(p=1)],
        weights={0: [1.0, 1.0], 2: [4.0, 0.1]}),
    "pnorm": lambda pkg: pkg.PNormDistance(p=2, weights={
        0: {"a": 1.0, "b": 1.0}, 2: {"a": 3.0, "b": 0.25},
        4: {"a": 0.5, "b": 2.0}}),
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_rides_the_chunks(kind, tmp_path):
    """test_fused.py:304-345: the schedule's row of each generation; the
    stored distances recompute under that generation's host weights (the
    JAX package's distance, initialized on the same observation), read
    back by the port's History and by the JAX package's."""
    obs = {"a": 1.0, "b": 2.0}
    dist = SCHEDULES[kind](tpt)
    prior = tpt.Distribution(theta=tpt.RV("norm", 0.0, 1.0))
    abc = tpt.ABCSMC(_port_two_stat(), prior, dist, population_size=300,
                     eps=tpt.MedianEpsilon(), seed=17, fused_generations=3,
                     fetch_dtype="float32", device="cpu")
    db = f"sqlite:///{tmp_path / 'sched.db'}"
    abc.new(db, obs)
    h = abc.run(max_nr_populations=6)
    assert h.n_populations == 6 and abc._weight_schedule_fused()
    assert h.get_telemetry(3).get("fused_chunk") == 3
    ref = SCHEDULES[kind](jpt)
    ref.initialize(0, x_0=obs)
    for hist in (h, JHistory(db)):
        _check_stored_distances_match_schedule(hist, ref, obs)
    # one counter read a round, one fetch a chunk: the table is not read
    by_kind = abc.sync_ledger.summary()["by_kind"]
    assert set(by_kind) == {"round_counters", "chunk_fetch"}
    assert by_kind["chunk_fetch"] == 2
    assert all(g["syncs"] == g["rounds"] for g in abc.generation_log)


SMALL = dict(n_leaps=100, n_obs=20)


def _bd_run(early, pop=64, gens=3):
    abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **SMALL),
                     tg.birth_death_prior(),
                     tpt.AggregatedDistance(
                         [tpt.PNormDistance(p=2),
                          tpt.PNormDistance(p=np.inf)], weights=[0.7, 1.3]),
                     population_size=pop, eps=tpt.MedianEpsilon(), seed=11,
                     early_reject=early, fused_generations=gens,
                     device="cpu")
    obs = {k: np.asarray(v) for k, v in jg.observed_birth_death(
        segments=5, **SMALL).items()}
    abc.new("sqlite://", obs)
    return abc.run(max_nr_populations=gens)


def test_config3_aggregate_early_reject_bit_identical():
    """Config 3's birth-death at a small population under the aggregated
    pair: theta, weights, distances and the epsilon trail bit-identical
    with early reject on and off, the same rounds, and slots retired."""
    h_on, h_off = _bd_run("auto"), _bd_run(False)
    assert h_on.max_t == h_off.max_t == 2
    np.testing.assert_array_equal(h_on.get_all_populations()["epsilon"],
                                  h_off.get_all_populations()["epsilon"])
    retired = 0
    for t in range(h_on.max_t + 1):
        df1, w1 = h_on.get_distribution(m=0, t=t)
        df2, w2 = h_off.get_distribution(m=0, t=t)
        assert np.array_equal(df1.to_numpy(), df2.to_numpy())
        assert np.array_equal(w1, w2)
        assert np.array_equal(
            h_on.get_weighted_distances(t)["distance"].to_numpy(),
            h_off.get_weighted_distances(t)["distance"].to_numpy())
        tel_on, tel_off = h_on.get_telemetry(t), h_off.get_telemetry(t)
        assert tel_on["rounds"] == tel_off["rounds"]
        assert "retired_early" not in tel_off
        retired += tel_on["retired_early"]
    assert retired > 0


def test_port_history_opens_in_the_jax_history(tmp_path):
    """A db the port writes under an adaptive aggregate opens in the JAX
    History: its populations, distances and the distance's config."""
    db = f"sqlite:///{tmp_path / 'agg.db'}"
    dist = tpt.AdaptiveAggregatedDistance([tpt.PNormDistance(p=2),
                                           tpt.PNormDistance(p=1)])
    abc = tpt.ABCSMC(gaussian.make_mean_only_model(noise_sd=NOISE_SD),
                     gaussian.mean_only_prior(), dist, population_size=200,
                     eps=tpt.MedianEpsilon(), seed=3, device="cpu")
    abc.new(db, {"x": X_OBS})
    h = abc.run(max_nr_populations=3)
    jh = JHistory(db)
    assert jh.max_t == h.max_t == 2
    for t in range(3):
        np.testing.assert_array_equal(
            jh.get_weighted_distances(t)["distance"].to_numpy(),
            h.get_weighted_distances(t)["distance"].to_numpy())
    runs = jh.all_runs()
    assert "AdaptiveAggregatedDistance" in runs["distance_function"].iloc[-1]
