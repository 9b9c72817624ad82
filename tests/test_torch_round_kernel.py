"""K26's round kernel (``DeviceContext.round`` / ``run_round``,
plain PyTorch versions on the CPU) against the JAX package's lane formulas
(``pyabc_tpu/inference/util.py::_lane_prior``, ``_lane_calibration``,
``_lane_transition``), on the port's own numbers.

JAX's threefry lanes cannot be fed to the port, so each check takes the
port's round (its theta and simulated rows) and recomputes every other
output with the JAX package's functions: the distance (``PNormDistance.
device_fn``), the accept test, the prior and proposal log-densities
(``logpdf_array``, ``MultivariateNormalTransition.device_logpdf`` of the
JAX host fit on the same rows) and the log weight, within rel 1e-5 (float32
sums in another order). Then the round's place in the stream: round r of
the per-round mode is bit-equal to round r of ``generation_while`` at the
same B, and a speculative round's counters meet no round's of any tag.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.core.sumstat_spec import SumStatSpec as JSpec  # noqa: E402
from pyabc_tpu.transition.multivariatenormal import (  # noqa: E402
    MultivariateNormalTransition as JMVN)
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.core.random import (CALIBRATION_GENERATION,  # noqa
                                         SPECULATIVE_BIT, RoundKey,
                                         generation_key, speculative_key)
from pyabc_tpu_torch.kernels import launch_counts, philox  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import model_selection as msel  # noqa: E402

torch.set_num_threads(1)

X_OBS = {"mean": 0.4, "std": 1.1}
W = np.array([1.0, 2.0])


def _toy_ctx(pop=300):
    abc = tpt.ABCSMC(gaussian.make_gaussian_model(), gaussian.default_prior(),
                     tpt.PNormDistance(p=2, weights=W), population_size=pop,
                     fused_generations=1, seed=9, device="cpu")
    abc.new("sqlite://", X_OBS)
    return abc, abc._build_context(pop, 0.0)


def _jax_distance(ss, w):
    jd = jpt.PNormDistance(p=2)
    fn = jd.device_fn(JSpec(X_OBS))
    x0 = jnp.asarray([X_OBS["mean"], X_OBS["std"]], jnp.float32)
    return np.asarray(jax.vmap(lambda x: fn(x, x0, jnp.asarray(
        w, jnp.float32)))(jnp.asarray(ss)))


def _jax_prior():
    return jpt.Distribution(mu=jpt.RV("norm", 0.0, 1.0),
                            sigma=jpt.RV("uniform", 0.2, 1.3))


def _fitted_rows(seed=0, n=200):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.normal(0.4, 0.3, n), rng.uniform(0.5, 1.3, n)], 1)
    return X, rng.random(n) + 0.1


def test_prior_round_matches_the_jax_lane():
    abc, ctx = _toy_ctx()
    eps = 0.9
    mode, dyn = ctx.build_dyn_args(t=0, eps_value=eps)
    assert mode == "prior"
    out = ctx.round(RoundKey(0, 3), 512, mode, dyn)
    th, ss = out["theta"].numpy(), out["sumstats"].numpy()
    d = _jax_distance(ss, W)
    np.testing.assert_allclose(out["distance"].numpy(), d, rtol=1e-5)
    away = np.abs(d - eps) > 1e-5 * eps
    np.testing.assert_array_equal(out["accepted"].numpy()[away],
                                  (d <= eps)[away])
    assert out["valid"].all()
    np.testing.assert_array_equal(out["log_weight"].numpy(), 0.0)
    logpri = np.asarray(jax.vmap(_jax_prior().logpdf_array)(jnp.asarray(th)))
    np.testing.assert_allclose(out["logq"].numpy(), logpri, rtol=1e-5,
                               atol=1e-6)


def test_calibration_round_matches_the_jax_lane():
    """``_lane_calibration``: accepted = valid, distance and log weight 0,
    logq the prior's log density; it draws what the prior round at the
    calibration word draws."""
    abc, ctx = _toy_ctx()
    mode, dyn = ctx.build_dyn_args(t=0, eps_value=np.inf)
    key = RoundKey(generation_key(-1), 0)
    assert key.generation == CALIBRATION_GENERATION
    cal = ctx.round(key, 256, "calibration", dyn)
    pri = ctx.round(key, 256, "prior", dyn)
    np.testing.assert_array_equal(cal["theta"].numpy(), pri["theta"].numpy())
    np.testing.assert_array_equal(cal["sumstats"].numpy(),
                                  pri["sumstats"].numpy())
    np.testing.assert_array_equal(cal["accepted"].numpy(),
                                  cal["valid"].numpy())
    np.testing.assert_array_equal(cal["distance"].numpy(), 0.0)
    np.testing.assert_array_equal(cal["log_weight"].numpy(), 0.0)
    np.testing.assert_array_equal(cal["logq"].numpy(), pri["logq"].numpy())


def test_transition_round_matches_the_jax_lane():
    """Theta from the host fit (K2), then logq under the JAX host fit of
    the same rows, the prior's log density and the log weight
    ``logpri - logq`` of every valid lane (-inf on the invalid ones)."""
    abc, ctx = _toy_ctx()
    X, w = _fitted_rows()
    abc.transitions[0].fit(X, w)
    jtr = JMVN()
    jtr.fit(pd.DataFrame(X, columns=["mu", "sigma"]), w)
    eps = 0.5
    mode, dyn = ctx.build_dyn_args(t=2, eps_value=eps,
                                   model_probabilities={0: 1.0},
                                   transitions=abc.transitions)
    assert mode == "transition"
    out = ctx.round(RoundKey(2, 1), 1024, mode, dyn)
    th = out["theta"].numpy()
    valid = out["valid"].numpy()
    jparams = {k: jnp.asarray(v) for k, v in jtr.device_params().items()}
    logq = np.asarray(jax.vmap(lambda q: JMVN.device_logpdf(q, jparams))(
        jnp.asarray(th)))
    logpri = np.asarray(jax.vmap(_jax_prior().logpdf_array)(jnp.asarray(th)))
    np.testing.assert_allclose(out["logq"].numpy(), logq, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(valid, np.isfinite(logpri))
    lw = out["log_weight"].numpy()
    np.testing.assert_allclose(lw[valid], (logpri - logq)[valid], rtol=1e-5,
                               atol=1e-5)
    assert np.all(lw[~valid] == -np.inf)
    d = _jax_distance(out["sumstats"].numpy(), W)
    np.testing.assert_allclose(out["distance"].numpy(), d, rtol=1e-5)
    away = np.abs(d - eps) > 1e-5 * eps
    np.testing.assert_array_equal(out["accepted"].numpy()[away],
                                  ((d <= eps) & valid)[away])


def test_transition_round_over_two_models_matches_the_jax_lane():
    """K = 2 (the tractable pair): each lane's model from the masked
    perturbation matrix, and the log weight ``log model prior + logpri -
    log model factor - logq`` under its model's JAX fit."""
    models, priors, _post = msel.tractable_pair()
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=200, fused_generations=1, seed=4,
                     device="cpu")
    abc.new("sqlite://", {"x": 1.0})
    ctx = abc._build_context(200, 0.0)
    rng = np.random.default_rng(1)
    jfits, probs = [], {0: 0.6, 1: 0.4}
    for m, tr in enumerate(abc.transitions):
        X = rng.normal(0.6 + 0.2 * m, 0.4, (90 + 30 * m, 1))
        w = rng.random(len(X)) + 0.1
        tr.fit(X, w)
        jtr = JMVN()
        jtr.fit(pd.DataFrame(X, columns=["theta"]), w)
        jfits.append({k: jnp.asarray(v) for k, v in
                      jtr.device_params().items()})
    mode, dyn = ctx.build_dyn_args(
        t=1, eps_value=0.3, model_probabilities=probs,
        transitions=abc.transitions,
        model_perturbation_kernel=abc.model_perturbation_kernel)
    out = ctx.round(RoundKey(1, 0), 2048, mode, dyn)
    m = out["m"].numpy()
    assert set(np.unique(m)) == {0, 1}
    th = out["theta"].numpy()
    # the JAX host arithmetic of build_dyn_args (util.py:3316-3333)
    mpk = jpt.ModelPerturbationKernel(2, probability_to_stay=0.7)
    matrix = np.asarray(mpk.device_params(), np.float64)
    log_factor = np.log(np.array([0.6, 0.4]) @ matrix)
    np.testing.assert_allclose(dyn["log_model_factor"].numpy(), log_factor,
                               rtol=1e-6)
    lw = out["log_weight"].numpy()
    jprior = jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0))
    for k in (0, 1):
        sel = m == k
        q = jnp.asarray(th[sel])
        logq = np.asarray(jax.vmap(lambda x: JMVN.device_logpdf(
            x, jfits[k]))(q))
        logpri = np.asarray(jax.vmap(jprior.logpdf_array)(q))
        ref = np.log(0.5) + logpri - log_factor[k] - logq
        np.testing.assert_allclose(lw[sel], ref, rtol=1e-5, atol=1e-5)


def test_prior_round_over_two_models_matches_the_jax_lane():
    """K = 2 prior and calibration rounds (``_lane_prior``,
    ``_lane_calibration``): logq is the lane's model's log prior plus its
    parameter prior's log density, which K2 forms; the calibration round
    proposes what the prior round at its word proposes (the pair's
    simulator draws from the run's generator)."""
    models, priors, _post = msel.tractable_pair()
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=200, fused_generations=1, seed=4,
                     device="cpu")
    abc.new("sqlite://", {"x": 1.0})
    ctx = abc._build_context(200, 0.0)
    mode, dyn = ctx.build_dyn_args(t=0, eps_value=np.inf)
    out = ctx.round(RoundKey(0, 1), 2048, mode, dyn)
    m, th = out["m"].numpy(), out["theta"].numpy()
    assert set(np.unique(m)) == {0, 1}
    jprior = jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0))
    logpri = np.asarray(jax.vmap(jprior.logpdf_array)(jnp.asarray(th)))
    np.testing.assert_allclose(out["logq"].numpy(), np.log(0.5) + logpri,
                               rtol=1e-5, atol=1e-6)
    key = RoundKey(generation_key(-1), 0)
    cal = ctx.round(key, 512, "calibration", dyn)
    pri = ctx.round(key, 512, "prior", dyn)
    for k in ("m", "theta", "logq"):
        np.testing.assert_array_equal(cal[k].numpy(), pri[k].numpy())


def test_round_r_is_bit_equal_to_generation_while_round_r():
    """The per-round mode's round r (``run_round`` at the key (t, r)) and
    round r of ``generation_while`` at the same B draw the same lanes: the
    accepted lanes of the round, in slot order, are the reservoir's rows
    of that round's slots, bit for bit."""
    abc, ctx = _toy_ctx()
    X, w = _fitted_rows(2)
    abc.transitions[0].fit(X, w)
    mode, dyn = ctx.build_dyn_args(t=3, eps_value=0.25,
                                   model_probabilities={0: 1.0},
                                   transitions=abc.transitions)
    B, n = 256, 150
    out = ctx.dispatch_generation(3, B, mode, dyn, n_cap=256, rec_cap=0,
                                  max_rounds=64, n_target=n)
    assert out["rounds"] >= 3
    res = {k: v.numpy() for k, v in out.items()
           if isinstance(v, torch.Tensor)}
    k = min(out["n_acc"], 256)
    seen = 0
    for r in range(out["rounds"]):
        rr = ctx.run_round(RoundKey(3, r), B, mode, dyn)
        acc = np.flatnonzero(rr.accepted & rr.valid)
        slots = r * B + acc
        rows = np.flatnonzero((res["slot"][:k] >= r * B)
                              & (res["slot"][:k] < (r + 1) * B))
        take = min(len(acc), len(rows))
        assert take > 0 or seen >= k
        np.testing.assert_array_equal(res["slot"][rows][:take],
                                      slots[:take])
        np.testing.assert_array_equal(res["theta"][rows][:take],
                                      rr.thetas[acc][:take].astype(
                                          np.float32))
        np.testing.assert_array_equal(res["sumstats"][rows][:take],
                                      rr.sumstats[acc][:take].astype(
                                          np.float32))
        np.testing.assert_array_equal(res["distance"][rows][:take],
                                      rr.distances[acc][:take].astype(
                                          np.float32))
        np.testing.assert_array_equal(res["log_weight"][rows][:take],
                                      rr.log_weights[acc][:take].astype(
                                          np.float32))
        seen += take


def test_run_round_reads_once_and_counts_no_cpu_launch():
    abc, ctx = _toy_ctx()
    mode, dyn = ctx.build_dyn_args(t=0, eps_value=1.0)
    before = launch_counts()
    rr = ctx.run_round(RoundKey(0, 0), 300, mode, dyn)
    assert ctx.sync_ledger.summary()["by_kind"] == {"round_fetch": 1}
    assert launch_counts() == before  # the CPU runs plain versions
    assert rr.thetas.shape == (300, 2) and rr.sumstats.shape == (300, 2)
    assert rr.ms.dtype == np.int32 and not rr.ms.any()
    assert rr.thetas.dtype == rr.logqs.dtype == np.float64
    with pytest.raises(ValueError, match="round mode"):
        ctx.round(RoundKey(0, 0), 300, "proposal", dyn)


def test_rounds_share_one_counter_table():
    """A round writes nothing on the device before its lane kernels: its
    counters are row r of one table of every round (``ROUNDS`` = r, the
    rest 0), made once; a round past the Philox stride raises."""
    abc, ctx = _toy_ctx()
    mode, dyn = ctx.build_dyn_args(t=0, eps_value=1.0)
    ctx.round(RoundKey(0, 5), 64, mode, dyn)
    five = ctx.counters
    ctx.round(RoundKey(0, 2), 64, mode, dyn)
    assert ctx.counters.untyped_storage().data_ptr() == \
        five.untyped_storage().data_ptr()
    assert five.tolist() == [0, 5, 0, 0, 0]
    assert ctx.counters.tolist() == [0, 2, 0, 0, 0]
    # the calibration's zero lanes are made once a B
    cal = ctx.round(RoundKey(generation_key(-1), 0), 64, "calibration", dyn)
    again = ctx.round(RoundKey(generation_key(-1), 1), 64, "calibration",
                      dyn)
    assert cal["distance"] is again["distance"] is again["log_weight"]
    with pytest.raises(ValueError, match="round 256 outside"):
        ctx.round(RoundKey(0, ctx.stride_rounds), 64, mode, dyn)


@pytest.mark.parametrize("t", [0, 1, 7, 255, 2 ** 20])
def test_speculative_words_meet_no_round(t):
    """The speculative round of generation t draws at the generation word
    ``t | 2^31`` (the JAX package's ``fold_in(generation_key, 1 << 20)``):
    no round of any tag of any generation, nor the calibration, has that
    word, so its counters, and with them its Philox words, are its own."""
    key = speculative_key(t)
    assert key == RoundKey(t | SPECULATIVE_BIT, 0)
    words = {generation_key(s) for s in range(0, 300)} | {
        generation_key(t), CALIBRATION_GENERATION}
    assert key.generation not in words
    # the same lanes, blocks, tag and round: every word differs
    ctr = torch.zeros(5, dtype=torch.int32)
    lanes = torch.arange(4096, dtype=torch.int64)[:, None]
    blocks = torch.arange(4, dtype=torch.int64)[None, :]
    for tag in (philox.TRANSITION, philox.SIM_NOISE, philox.MODEL):
        spec = philox.lane_blocks(philox.PhiloxStream(
            9, key.generation, tag, 256, ctr), lanes, blocks)
        base = philox.lane_blocks(philox.PhiloxStream(
            9, t, tag, 256, ctr), lanes, blocks)
        same = sum(int((a == b).sum()) for a, b in zip(spec, base))
        assert same < 8  # chance coincidences of 32-bit words only
