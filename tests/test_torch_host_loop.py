"""The per-generation host loop (``ABCSMC`` with ``fused_generations=1`` or
``BatchedSampler(fused=False)``; ``inference/dispatch.py``) against the JAX
package on the CPU.

Its host parts on the same numpy inputs: the MVN host fit (``smart_cov``,
the Cholesky factor, precision, logdet, density) within 1e-12 and its
float32 device params within 1 ulp; the epsilons' host updates exactly;
the adaptive distance's host refit exactly on a host matrix and within rel
1e-5 through K9 on a record ring left on the device; the speculation
verdict on a table of configurations. Then whole runs, compared
statistically (the port's Philox streams are not threefry's): BASELINE
config 1 (the 2-parameter Gaussian, ``make_gaussian_model``, a p = 2 norm,
``MedianEpsilon``, pop 500, 5 generations) under the pipelined loop, with
and without a speculative round, the serial loop and the per-round mode,
4 seeds each, against the JAX package's host loop over the same seeds:
the seed means of the posterior means within 0.05 and of each epsilon
within 15 % (one seed's posterior mean moves by about 0.02 at pop 500);
the tractable pair (K = 2) over 8 seeds within 0.05 of the exact P(m = 0)
0.5529; LV config 2 (``AdaptivePNormDistance``, ``MedianEpsilon``) with
its record ring reduced on the device and never read, and over 3 seeds
beside the JAX package's host loop (epsilons within 6 %, posterior means
within 0.1); the History a port
run writes read by the JAX package's; and every configuration the host
loop refuses, with its ROADMAP item.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import gaussian as jgauss  # noqa: E402
from pyabc_tpu.sampler import BatchedSampler as JSampler  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu.transition.multivariatenormal import (  # noqa: E402
    MultivariateNormalTransition as JMVN)
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.inference import dispatch  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import lotka_volterra as lv  # noqa: E402
from pyabc_tpu_torch.models import model_selection as msel  # noqa: E402
from pyabc_tpu_torch.sampler import BatchedSampler, DeviceRecords  # noqa
from pyabc_tpu_torch.transition import util as tutil  # noqa: E402

torch.set_num_threads(1)

X_OBS = {"mean": 0.4, "std": 1.1}
POP, GENS, SEEDS = 500, 5, (0, 1, 2, 3)
PAIR_X, PAIR_POP, PAIR_GENS, PAIR_SEEDS = 0.7, 600, 6, tuple(range(8))
PAIR_EXACT = 0.5529


# ---------------------------------------------------------------- host fit
@pytest.mark.parametrize("n,d", [(1, 2), (37, 1), (200, 2), (500, 4)])
def test_host_fit_matches_jax(n, d):
    rng = np.random.default_rng(n + d)
    X = rng.normal(0.5, 0.3, (n, d))
    if d > 1:
        X[:, -1] = 0.25  # a zero-variance direction: smart_cov's guard
    w = rng.random(n) + 0.05
    np.testing.assert_array_equal(tutil.smart_cov(X, w / w.sum()),
                                  jutil.smart_cov(X, w / w.sum()))
    port, ref = tpt.MultivariateNormalTransition(scaling=1.3), JMVN(
        scaling=1.3)
    port.fit(X, w)
    ref.fit(pd.DataFrame(X), w)
    for a, b in ((port._chol, ref._chol), (port._prec, ref._prec)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(
            b).max())
    assert abs(port._logdet - ref._logdet) <= 1e-12 * max(1.0, abs(
        ref._logdet))
    q = rng.normal(0.5, 0.4, (25, d))
    np.testing.assert_allclose(port.pdf(q), ref.pdf(pd.DataFrame(q)),
                               rtol=1e-12)
    dp, jp = port.device_params(), ref.device_params()
    for k in ("thetas", "weights", "chol", "prec", "center", "thetas_c",
              "quad", "logdet"):
        np.testing.assert_array_max_ulp(dp[k], np.asarray(jp[k]), maxulp=1)
    assert dp["dim"] == float(jp["dim"])


def test_device_params_pad_as_jax():
    """Rows padded with weight 0 and columns with zeros
    (``pad_transition_params``); the ancestor cdf repeats over the padded
    rows so K2 never draws one."""
    from pyabc_tpu.inference.util import pad_transition_params

    rng = np.random.default_rng(3)
    X, w = rng.normal(size=(50, 2)), rng.random(50)
    port, ref = tpt.MultivariateNormalTransition(), JMVN()
    port.fit(X, w)
    ref.fit(pd.DataFrame(X), w)
    dp = port.device_params(64, 3)
    jp = pad_transition_params(ref.device_params(), 64, 3)
    for k in jp:
        if k != "dim":
            np.testing.assert_array_max_ulp(dp[k], np.asarray(jp[k]),
                                            maxulp=1)
    assert np.all(np.diff(dp["cdf"]) >= 0)
    assert dp["cdf"][49] == dp["cdf"][-1]
    np.testing.assert_allclose(dp["cdf"][49], 1.0, rtol=1e-6)


# ---------------------------------------------------------------- epsilon
@pytest.mark.parametrize("cls,kw", [
    ("MedianEpsilon", {}), ("QuantileEpsilon", {"alpha": 0.3}),
    ("QuantileEpsilon", {"alpha": 0.8, "weighted": False}),
    ("QuantileEpsilon", {"alpha": 0.5, "quantile_multiplier": 0.9}),
    ("QuantileEpsilon", {"initial_epsilon": 2.5})])
def test_quantile_epsilon_host_updates_match_jax(cls, kw):
    rng = np.random.default_rng(7)
    port, ref = getattr(tpt, cls)(**kw), getattr(jpt, cls)(**kw)
    d0 = rng.random(300) * 4
    wd0 = {"distance": d0, "w": np.full(300, 1 / 300)}
    port.initialize(0, get_weighted_distances=lambda: wd0)
    ref.initialize(0, get_weighted_distances=lambda: pd.DataFrame(wd0))
    for t in (1, 2, 3):
        w = rng.random(200)
        wd = {"distance": rng.random(200) * (4 - t), "w": w / w.sum()}
        port.update(t, get_weighted_distances=lambda: wd)
        ref.update(t, get_weighted_distances=lambda: pd.DataFrame(wd))
    for t in range(4):
        assert port(t) == ref(t)


def test_constant_and_list_epsilons_match_jax():
    for port, ref in ((tpt.ConstantEpsilon(0.7), jpt.ConstantEpsilon(0.7)),
                      (tpt.ListEpsilon([3, 2, 1.5]),
                       jpt.ListEpsilon([3, 2, 1.5]))):
        port.initialize(0)
        port.update(1, get_weighted_distances=lambda: None)
        assert [port(t) for t in range(3)] == [ref(t) for t in range(3)]


# --------------------------------------------------------------- distance
def _lv_rows(seed, n=400):
    rng = np.random.default_rng(seed)
    ss = np.abs(rng.normal(10.0, 3.0, (n, 40)) * rng.random(40) * 5)
    return ss, ss[0] * 0.9


@pytest.mark.parametrize("scale", ["median_absolute_deviation",
                                   "standard_deviation", "span",
                                   "mean_absolute_deviation_to_observation"])
def test_adaptive_host_update_matches_jax(scale):
    """On a host matrix the same numpy arithmetic (exact); on a record
    ring left on the device, K9's scale (its plain version here) within rel
    1e-5, as the collected ``rec_scale`` or reduced on request."""
    ss0, x0 = _lv_rows(1)
    ss1, _ = _lv_rows(2)
    x0d = {"pred": x0[:20], "prey": x0[20:]}
    spec = SumStatSpec(x0d)
    from pyabc_tpu.distance import scale as jscale
    from pyabc_tpu_torch.distance import scale as tscale

    port = tpt.AdaptivePNormDistance(
        p=2, scale_function=getattr(tscale, scale), max_weight_ratio=50)
    ref = jpt.AdaptivePNormDistance(
        p=2, scale_function=getattr(jscale, scale), max_weight_ratio=50)
    port.initialize(spec)
    port.host_initialize(0, lambda: ss0, x0)
    ref.initialize(0, lambda: ss0, x0d)
    np.testing.assert_array_equal(port.weights[0], ref.weights[0])
    assert port.update(1, lambda: ss1) and ref.update(1, lambda: ss1)
    np.testing.assert_array_equal(port.weights[1], ref.weights[1])
    np.testing.assert_array_equal(port.host_batch(ss1, x0, 1),
                                  ref.host_batch(ss1, x0, 1))
    valid = np.random.default_rng(3).random(len(ss1)) < 0.8
    rec = DeviceRecords(torch.from_numpy(ss1.astype(np.float32)),
                        torch.from_numpy(valid))
    assert port.update(2, lambda: rec)
    ref.update(2, lambda: ss1.astype(np.float32)[valid])
    np.testing.assert_allclose(port.weights[2], ref.weights[2], rtol=1e-5)
    assert rec.sync_ledger.summary()["by_kind"] == {"scale_fetch": 1}
    scale_vec = ref.scale_function(ss1[valid], x0)
    collected = DeviceRecords(None, None, scale=np.float32(scale_vec))
    port.update(3, lambda: collected)
    ref.update(3, lambda: np.asarray(ss1[valid]))
    np.testing.assert_allclose(port.weights[3], ref.weights[3], rtol=1e-6)


# ---------------------------------------------------- speculation verdict
def _spec_pair(dist, acceptor=None, K=1, max_rec=np.inf):
    """The same configuration in both packages, initialized."""
    if K == 1:
        jm, tm = jgauss.make_gaussian_model(), gaussian.make_gaussian_model()
        jp, tp_ = jgauss.default_prior(), gaussian.default_prior()
        obs = X_OBS
    else:
        import pyabc_tpu.models.model_selection as jmsel

        jm, jp, _ = jmsel.tractable_pair()
        tm, tp_, _ = msel.tractable_pair()
        obs = {"x": PAIR_X}
    jd, td = dist(jpt), dist(tpt)
    ja = acceptor(jpt) if acceptor else None
    ta = acceptor(tpt) if acceptor else None
    jabc = jpt.ABCSMC(jm, jp, jd, acceptor=ja, fused_generations=1,
                      max_nr_recorded_particles=max_rec)
    jabc.new("sqlite://", obs)
    jd.initialize(0, None, obs)
    verdict = {"jax": jabc._speculation_capable()}
    if np.isfinite(max_rec):
        return verdict
    tabc = tpt.ABCSMC(tm, tp_, td, acceptor=ta, fused_generations=1,
                      device="cpu")
    tabc.new("sqlite://", obs)
    td.initialize(tabc.spec)
    verdict["port"] = dispatch.speculation_capable(tabc)
    return verdict


@pytest.mark.parametrize("case,expect", [
    (dict(dist=lambda p: p.PNormDistance(p=2)), True),
    (dict(dist=lambda p: p.PNormDistance(p=np.inf)), True),
    (dict(dist=lambda p: p.PNormDistance(p=2, weights=[1.0, 2.0])), True),
    (dict(dist=lambda p: p.PNormDistance(
        p=2, weights={0: [1.0, 2.0], 2: [2.0, 1.0]})), False),
    (dict(dist=lambda p: p.AdaptivePNormDistance(p=2)), False),
    (dict(dist=lambda p: p.PNormDistance(p=2),
          acceptor=lambda p: p.UniformAcceptor(use_complete_history=True)),
     False),
    (dict(dist=lambda p: p.PNormDistance(p=1), K=2), True),
    (dict(dist=lambda p: p.PNormDistance(p=2), max_rec=500), False)])
def test_speculation_verdict_matches_jax(case, expect):
    verdict = _spec_pair(**case)
    assert verdict["jax"] is expect
    # a finite record cap is refused by the port at construction (item 12)
    if "port" in verdict:
        assert verdict["port"] is expect


# ------------------------------------------------------------ whole runs
def _toy(pkg, seed, mode=None, db="sqlite://"):
    if pkg == "jax":
        abc = jpt.ABCSMC(jgauss.make_gaussian_model(), jgauss.default_prior(),
                         jpt.PNormDistance(p=2), population_size=POP,
                         eps=jpt.MedianEpsilon(), seed=seed,
                         fused_generations=1)
    else:
        kw = {"pipelined": dict(fused_generations=1),
              "speculative": dict(fused_generations=1),
              "serial": dict(fused_generations=1, pipeline=False),
              "rounds": dict(sampler=BatchedSampler(fused=False))}[mode]
        abc = tpt.ABCSMC(gaussian.make_gaussian_model(),
                         gaussian.default_prior(), tpt.PNormDistance(p=2),
                         population_size=POP, eps=tpt.MedianEpsilon(),
                         seed=seed, device="cpu", **kw)
        if mode == "speculative":
            abc.speculation_min_adapt_s = 0.0
    abc.new(db, X_OBS)
    h = abc.run(max_nr_populations=GENS)
    eps = h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()
    df, w = h.get_distribution(0, h.max_t)
    means = [float(np.sum(df[k] * w)) for k in ("mu", "sigma")]
    return abc, h, eps, means


@pytest.fixture(scope="module")
def jax_toy():
    runs = [_toy("jax", s) for s in SEEDS]
    return (np.mean([r[2] for r in runs], 0),
            np.mean([r[3] for r in runs], 0))


@pytest.mark.parametrize("mode", ["pipelined", "speculative", "serial",
                                  "rounds"])
def test_config1_host_loop_matches_jax(mode, jax_toy):
    jeps, jmeans = jax_toy
    runs = [_toy("port", s, mode) for s in SEEDS]
    eps = np.mean([r[2] for r in runs], 0)
    means = np.mean([r[3] for r in runs], 0)
    assert all(r[1].max_t == GENS - 1 for r in runs)
    np.testing.assert_allclose(eps, jeps, rtol=0.15)
    np.testing.assert_allclose(means, jmeans, atol=0.05)
    abc = runs[0][0]
    by_kind = abc.sync_ledger.summary()["by_kind"]
    if mode == "rounds":
        # one read a round, the calibration's too
        assert set(by_kind) == {"round_fetch"}
        assert by_kind["round_fetch"] == sum(
            g["rounds"] for g in abc.generation_log) + 1
    else:
        # a counter read a round and a collect a generation
        assert by_kind["generation_collect"] == GENS + 1
        assert by_kind["round_counters"] == sum(
            g["rounds"] for g in abc.generation_log) + 1
    spec = sum(g.get("speculative_accepted", 0) for g in abc.generation_log)
    assert (spec > 0) == (mode == "speculative")
    if mode == "speculative":
        # every generation but the first two: the first adaptation is
        # the one that first measures the strategies' time
        assert by_kind["speculative_fetch"] == GENS - 2


def test_the_loops_draw_alike_without_speculation():
    """The pipelined and the serial loop run the same rounds (no
    speculative round at the default threshold on this fast toy), and the
    per-round mode draws the same lanes while B stays: generation 0 of
    every mode is bit-identical."""
    pops = {m: _toy("port", 5, m)[1] for m in ("pipelined", "serial",
                                                "rounds")}
    ref = pops["serial"]
    for m in ("pipelined", "rounds"):
        a, wa = pops[m].get_distribution(0, 0)
        b, wb = ref.get_distribution(0, 0)
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
        np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(
        pops["pipelined"].get_all_populations()["epsilon"].to_numpy(),
        ref.get_all_populations()["epsilon"].to_numpy())


def test_tractable_pair_on_the_host_loop():
    """K = 2 through the pipelined host loop: the 8-seed mean of P(m = 0)
    within 0.05 of the exact 0.5529 (one seed's sd is about 0.03)."""
    p0 = []
    for seed in PAIR_SEEDS:
        models, priors, post = msel.tractable_pair()
        abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                         population_size=PAIR_POP, fused_generations=1,
                         seed=seed, device="cpu")
        abc.new("sqlite://", {"x": PAIR_X})
        h = abc.run(max_nr_populations=PAIR_GENS)
        assert h.max_t == PAIR_GENS - 1
        probs = h.get_model_probabilities(h.max_t)["p"]
        p0.append(float(probs.get(0, 0.0)))
        assert abc.model_probs.get(0, 0.0) == pytest.approx(p0[-1])
    assert abs(float(post(PAIR_X)[0]) - PAIR_EXACT) < 1e-4
    assert abs(np.mean(p0) - PAIR_EXACT) < 0.05


def test_lv_config2_reduces_its_ring_on_the_device():
    """LV config 2 (``AdaptivePNormDistance``, ``MedianEpsilon``) through
    ``BatchedSampler()``: each generation's scale comes with its collect,
    the ring is never read, the weights refit every generation, and the
    epsilon trail is finite."""
    abc = tpt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                     tpt.AdaptivePNormDistance(p=2), population_size=300,
                     eps=tpt.MedianEpsilon(), sampler=BatchedSampler(),
                     fused_generations=1, seed=2, device="cpu")
    abc.new("sqlite://", lv.observed_data())
    h = abc.run(max_nr_populations=3)
    assert h.max_t == 2
    by_kind = abc.sync_ledger.summary()["by_kind"]
    assert set(by_kind) == {"round_counters", "generation_collect"}
    assert sorted(abc.distance_function.weights) == [0, 1, 2, 3]
    eps = h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()
    assert np.all(np.isfinite(eps)) and np.all(eps > 0)
    assert all(h.get_telemetry(t)["distance_changed"] for t in range(3))


def test_lv_config2_host_loop_matches_jax():
    """LV config 2 on both packages' host loops (pop 500, 4 generations,
    seeds 0-2, the JAX observation): the seed means of each epsilon within
    6 % and of the posterior means within 0.1 (a seed's trail moves by
    about 2 of 52, its means by about 0.05)."""
    from pyabc_tpu.models import lotka_volterra as jlv

    obs = {k: np.asarray(v) for k, v in jlv.observed_data(seed=0).items()}
    trails, means = {"jax": [], "port": []}, {"jax": [], "port": []}
    for seed in range(3):
        for pkg in ("jax", "port"):
            if pkg == "jax":
                abc = jpt.ABCSMC(jlv.make_lv_model(), jlv.default_prior(),
                                 jpt.AdaptivePNormDistance(p=2),
                                 population_size=500,
                                 eps=jpt.MedianEpsilon(), seed=seed,
                                 fused_generations=1)
            else:
                abc = tpt.ABCSMC(lv.make_lv_model(), lv.default_prior(),
                                 tpt.AdaptivePNormDistance(p=2),
                                 population_size=500,
                                 eps=tpt.MedianEpsilon(), seed=seed,
                                 fused_generations=1, device="cpu")
            abc.new("sqlite://", obs)
            h = abc.run(max_nr_populations=4)
            trails[pkg].append(h.get_all_populations().query(
                "t >= 0")["epsilon"].to_numpy())
            df, w = h.get_distribution(0, h.max_t)
            means[pkg].append([float(np.sum(df[k] * w))
                               for k in ("alpha", "beta", "gamma", "delta")])
    np.testing.assert_allclose(np.mean(trails["port"], 0),
                               np.mean(trails["jax"], 0), rtol=0.06)
    np.testing.assert_allclose(np.mean(means["port"], 0),
                               np.mean(means["jax"], 0), atol=0.1)


def test_port_db_opens_in_the_jax_history(tmp_path):
    db = "sqlite:///" + str(tmp_path / "host.db")
    _abc, h, eps, _m = _toy("port", 1, "serial", db=db)
    jh = jpt.History(db)
    assert jh.max_t == GENS - 1
    np.testing.assert_array_equal(
        jh.get_all_populations().query("t >= 0")["epsilon"].to_numpy(), eps)
    tel = jh.get_telemetry(2)
    for k in ("sample_s", "n_evaluations", "adapt_s", "persist_s",
              "acceptance_rate", "distance_changed"):
        assert k in tel, k
    df, w = jh.get_distribution(0, 2)
    assert len(df) == POP and np.isclose(np.sum(w), 1.0)


# --------------------------------------------------------------- refusals
def _refused(match_item, **kw):
    base = dict(models=gaussian.make_gaussian_model(),
                parameter_priors=gaussian.default_prior(),
                fused_generations=1, device="cpu")
    base.update(kw)
    with pytest.raises(NotImplementedError,
                       match=f"item {match_item}\\)"):
        tpt.ABCSMC(**base)


@pytest.mark.parametrize("kw,item", [
    (dict(transitions=tpt.LocalTransition()), "11"),
    (dict(transitions=tpt.GridSearchCV(tpt.MultivariateNormalTransition(),
                                       {"scaling": [0.5, 1.0]}, cv=3)),
     "11"),
    (dict(distance_function=tpt.IndependentNormalKernel(var=[0.1, 0.1]),
          eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor()), "11"),
    (dict(distance_function=tpt.PNormDistance(
        p=2, sumstat=tpt.PredictorSumstat(tpt.LinearPredictor()))), "14"),
    (dict(distance_function=tpt.AggregatedDistance(
        [tpt.PNormDistance(p=2), tpt.PNormDistance(p=1)])), "12"),
    (dict(population_size=tpt.AdaptivePopulationSize(
        200, max_population_size=400)), "16"),
    (dict(early_reject=True), "13"),
    (dict(sampler=JSampler()), "16"),
    (dict(max_nr_recorded_particles=100), "12")])
def test_host_loop_refusals_name_their_item(kw, item):
    _refused(item, **kw)


def test_per_round_sampler_takes_the_host_loop_at_any_chunk_size():
    abc = tpt.ABCSMC(gaussian.make_gaussian_model(),
                     gaussian.default_prior(),
                     sampler=BatchedSampler(fused=False), device="cpu")
    assert abc.host_loop and abc.fused_generations == 8
    assert not tpt.ABCSMC(gaussian.make_gaussian_model(),
                          gaussian.default_prior(),
                          device="cpu").host_loop
