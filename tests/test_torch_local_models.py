"""LocalTransition over several models: K12-K15's per-model entries, K2's
and K14's K > 1 local modes and K26 under K15's fitted mask against the
JAX package on the CPU, then whole runs of the tractable pair (the JAX
suite's K = 2 local run) and an adaptive n over two models, and the gates
of what stays unported.

The same numpy inputs, made from a seed, go through the JAX functions
(``LocalTransition.device_fit`` per model on the masked weights,
``device_proposal_drift``, ``device_logpdf``, the refit decision of
``inference/util.py:1908-1987``) and their counterparts in the port (the
plain PyTorch versions). Tolerances, with their reasons:

- factors: chols 1e-5 + 1e-4 relative, logdets 1e-4, precisions 1e-3 of
  the row's largest entry (the port inverts through the Cholesky factor,
  the JAX package by LU); carried params exactly;
- drift: 1e-6 + 1e-4 relative (float32 moments in another order);
  decisions exactly;
- draws: theta 1e-5 + 1e-5 relative on the port's own uniforms and
  normals, away from a CDF step, where the ancestor is the same;
- densities: 1e-4 + 1e-5 relative (float32 sums in another order);
- whole runs: the JAX suite's rules (P(m = 0) within 0.15 of the exact
  value and of the JAX package's, epsilon trails within 25 %).
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
from pyabc_tpu.transition import model_perturbation as jmpk  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu.transition.local_transition import (  # noqa: E402
    LocalTransition as JLocal)
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.random_variables import stacked_arrays  # noqa
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.local_logpdf import local_logpdf  # noqa: E402
from pyabc_tpu_torch.kernels.model_step import model_step  # noqa: E402
from pyabc_tpu_torch.kernels.proposal_drift import (  # noqa: E402
    proposal_drift)
from pyabc_tpu_torch.kernels.propose import propose_local  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.models import gillespie  # noqa: E402
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402
from pyabc_tpu_torch.transition import LocalTransition  # noqa: E402

torch.set_num_threads(2)

DIMS = (1, 2, 2)
D_MAX = 2
K = 3
N_CAP = 96
STATICS = dict(scaling=1.0, k_cap=16, k_fixed=-1, k_fraction=0.25,
               k_max=None, selection="auto")


def _reservoir(seed, counts=None, n=N_CAP, n_keep=80):
    """A reservoir over three models (dims 1, 2, 2 on d_max 2): the kept
    rows' models drawn at random, or ``counts`` kept rows per model in
    order."""
    rng = np.random.default_rng(seed)
    if counts is None:
        m = rng.integers(0, K, n).astype(np.int32)
    else:
        m = np.concatenate([np.full(c, k, np.int32)
                            for k, c in enumerate(counts)])
        n_keep = len(m)
        m = np.concatenate([m, rng.integers(0, K, n - n_keep)]).astype(
            np.int32)
    theta = rng.normal([0.5, 1.0], [0.2, 0.4], size=(n, D_MAX))
    theta[m == 0, 1] = 0.0
    k_mask = np.arange(n) < n_keep
    w = np.where(k_mask, rng.random(n) + 0.1, 0.0)
    return (theta.astype(np.float32), (w / w.sum()).astype(np.float32), m,
            k_mask)


def _jax_fit(theta, w, m, k):
    w_k = np.where(m == k, w, 0.0).astype(np.float32)
    return jax.tree.map(np.asarray, JLocal.device_fit(
        jnp.asarray(theta), jnp.asarray(w_k), dim=DIMS[k], **STATICS))


def _configs():
    return [LocalTransition.field_config(N_CAP, dk, **STATICS)
            for dk in DIMS]


def _factors_close(got, ref):
    np.testing.assert_array_equal(got["thetas"], ref["thetas"])
    np.testing.assert_allclose(got["weights"], ref["weights"], rtol=1e-6)
    np.testing.assert_allclose(got["chols"], ref["chols"], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got["logdets"], ref["logdets"], atol=1e-4,
                               rtol=1e-4)
    n = got["precs"].shape[0]
    scale = np.abs(ref["precs"]).reshape(n, -1).max(axis=1)
    err = np.abs(got["precs"] - ref["precs"]).reshape(n, -1).max(axis=1)
    assert np.all(err <= 1e-3 * np.maximum(scale, 1e-30))


# ---------------------------------------------------- K12, K13, K15 per model
@pytest.mark.parametrize("incremental", [False, True])
def test_refit_models_matches_jax(incremental):
    """Model 0 refits (its k from its own count), model 1 (never fitted)
    has dim rows (below dim + 1: its old params carry forward and it stays
    unfitted, where the counts' rule of the MVN path would fit it) and
    model 2 none (carried); ``fitted`` follows ``util.py:1944-1948`` and
    K26's matrix is masked with it."""
    theta0, w0, m0, _k0 = _reservoir(1)
    prev_fits = [_jax_fit(theta0, w0, m0, k) for k in range(K)]
    prev = convert.stacked_local_transition_params(prev_fits, device="cpu")
    theta, w, m, k_mask = _reservoir(2, counts=(60, 2, 0))
    fitted = torch.tensor([True, False, False])
    t = torch.from_numpy
    dec = proposal_drift.models(
        prev["thetas"], prev["weights"], t(theta), t(w), t(k_mask), t(m),
        dims=DIMS, fitted=fitted,
        gens_since=torch.zeros((), dtype=torch.int32), every=1,
        thr=math.inf, min_counts=[dk + 1 for dk in DIMS])
    assert bool(dec["refit"])
    assert dec["flag"].tolist() == [1, 0, 0]
    # util.py:1944-1948: refit_ok | (fitted & counts > 0)
    assert dec["fitted"].tolist() == [True, False, False]
    np.testing.assert_array_equal(
        dec["w_models"].numpy(),
        np.stack([np.where(m == k, w, 0.0) for k in range(K)]))
    params, rows = LocalTransition.device_fit_models(
        t(theta), dec["w_models"], prev, dec["flag"], dims=list(DIMS),
        configs=_configs(), incremental=incremental)
    ref0 = _jax_fit(theta, w, m, 0)
    _factors_close({k: v[0].numpy() for k, v in params.items()
                    if k != "dims"}, ref0)
    for k in (1, 2):
        for key in ("thetas", "weights", "cdf", "chols", "precs", "logdets",
                    "lconst"):
            assert torch.equal(params[key][k], prev[key][k]), (k, key)
    assert int(rows) == (int((~torch.isclose(
        params["chols"][0], prev["chols"][0])).any(-1).any(-1).sum())
        if incremental else N_CAP)
    mpk = jmpk.ModelPerturbationKernel(K, 0.7).device_params()
    step = model_step(t(m), t(w), t(k_mask), fitted,
                      torch.from_numpy(mpk), fitted_next=dec["fitted"])
    masked = mpk * np.array([1.0, 0.0, 0.0], np.float32)[None, :]
    masked = masked / masked.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(step["matrix"].numpy(), masked, rtol=1e-6)
    assert step["fitted"].tolist() == [True, False, False]
    # the counts' own rule (the MVN path's) would have fitted model 1
    plain = model_step(t(m), t(w), t(k_mask), fitted, torch.from_numpy(mpk))
    assert plain["counts"].tolist() == [60, 2, 0]
    assert plain["fitted"].tolist() == [True, True, False]


def _jax_decision(prev_fits, theta, w, m, k_mask, fitted, gens_since, every,
                  thr):
    """``inference/util.py:1958-1987`` on the JAX package's functions."""
    m_arr, km, w_norm = jnp.asarray(m), jnp.asarray(k_mask), jnp.asarray(w)
    counts = jnp.stack([(km & (m_arr == k)).sum() for k in range(K)])
    drifts = []
    for k in range(K):
        vmask = (jnp.arange(D_MAX) < DIMS[k]).astype(jnp.float32)
        w_k = jnp.where((m_arr == k) & km, w_norm, 0.0)
        d_k = jutil.device_proposal_drift(
            jnp.asarray(prev_fits[k]["thetas"]),
            jnp.asarray(prev_fits[k]["weights"]), jnp.asarray(theta), w_k,
            vmask)
        drifts.append(jnp.where(fitted[k] & (counts[k] > 0), d_k, 0.0))
    drift = jnp.max(jnp.stack(drifts))
    tick = gens_since + 1
    fitted = jnp.asarray(fitted)
    refit = ((tick >= every) | (drift > thr)
             | jnp.any(~fitted & (counts > 0)) | ~jnp.any(fitted))
    ok = counts >= jnp.asarray([dk + 1 for dk in DIMS])
    fitted_next = jnp.where(refit, ok | (fitted & (counts > 0)),
                            fitted & (counts > 0))
    return (float(drift), bool(refit), np.asarray(refit & ok).astype(int),
            int(jnp.where(refit, 0, tick)), np.asarray(fitted_next))


#: (fitted, gens_since, drift threshold, scale of the new rows): the tick
#: below and at refit_every=2, the drift guard, the forced refit of a model
#: with rows and no fit, and no model fitted
DRIFT_CASES = {
    "tick_below": ((True, True, True), 0, math.inf, 1.0),
    "tick_at": ((True, True, True), 1, math.inf, 1.0),
    "drift_guard": ((True, True, True), 0, 0.3, 1.5),
    "forced": ((True, False, True), 0, math.inf, 1.0),
    "none_fitted": ((False, False, False), 0, math.inf, 1.0),
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_drift_and_decisions_match_jax(case):
    fitted, gens, thr, scale = DRIFT_CASES[case]
    theta0, w0, m0, _k0 = _reservoir(3)
    prev_fits = [_jax_fit(theta0, w0, m0, k) for k in range(K)]
    prev = convert.stacked_local_transition_params(prev_fits, device="cpu")
    theta, w, m, k_mask = _reservoir(4, counts=(40, 30, 5))
    theta = (theta * scale).astype(np.float32)
    drift, refit, flag, gens_next, fitted_next = _jax_decision(
        prev_fits, theta, w, m, k_mask, np.array(fitted), gens, 2, thr)
    t = torch.from_numpy
    got = proposal_drift.models(
        prev["thetas"], prev["weights"], t(theta), t(w), t(k_mask), t(m),
        dims=DIMS, fitted=torch.tensor(fitted),
        gens_since=torch.tensor(gens, dtype=torch.int32), every=2, thr=thr,
        min_counts=[dk + 1 for dk in DIMS])
    assert float(got["drift"]) == pytest.approx(drift, rel=1e-4, abs=1e-6)
    assert bool(got["refit"]) == refit
    assert got["flag"].tolist() == flag.tolist()
    assert int(got["gens_since"]) == gens_next
    assert got["fitted"].tolist() == fitted_next.tolist()
    if case == "drift_guard":
        assert refit and drift > 0.3
    if case == "tick_below":
        assert not refit and flag.tolist() == [0, 0, 0]


# ------------------------------------------------------------ K2 and K14
def _priors():
    wide = [tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0)),
            tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0),
                             b=tpt.RV("uniform", -500.0, 1000.0)),
            tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0),
                             k=tpt.RV("norm", 1.0, 100.0))]
    return stacked_arrays(wide, "cpu")


def _fits_and_params(seed):
    theta, w, m, _k = _reservoir(seed)
    fits = [_jax_fit(theta, w, m, k) for k in range(K)]
    return fits, convert.stacked_local_transition_params(fits, device="cpu")


def test_propose_local_models_is_jax_formula_on_the_same_numbers():
    """K2's K > 1 local mode: the models' frequencies follow the masked
    perturbation of the model probabilities (model 2 unfitted: never
    drawn), and given the port's own uniforms and normals theta is
    thetas[m, idx] + chols[m, idx] z with idx by inverse CDF over model
    m's JAX weights, padded with exact zeros past the model's dim."""
    fits, params = _fits_and_params(5)
    probs = np.array([0.3, 0.5, 0.2], np.float32)
    fitted = np.array([True, True, False])
    mpk = jmpk.ModelPerturbationKernel(K, 0.7).device_params()
    masked = mpk * fitted[None, :]
    masked = (masked / masked.sum(axis=1, keepdims=True)).astype(np.float32)
    B = 20000
    stream = philox.PhiloxStream(5, 3, philox.TRANSITION, 256,
                                 torch.zeros(4, dtype=torch.int32))
    th, _lp, valid, mm = propose_local.models(
        stream, B, _priors(), torch.from_numpy(np.log(probs)), params,
        torch.from_numpy(masked))
    assert bool(valid.all())
    want = probs @ masked
    freq = np.bincount(mm.numpy(), minlength=K) / B
    se = np.sqrt(want * (1 - want) / B) + 1e-12
    assert (np.abs(freq - want) < 5 * se).all() and freq[2] == 0
    lanes = torch.arange(B)
    u = philox.uniforms(stream, lanes, 0, 0).numpy()
    z = philox.normals(stream, lanes, 1, D_MAX).numpy()
    mm, th = mm.numpy(), th.numpy()
    for k in range(2):
        sel = mm == k
        p_cuml = np.cumsum(fits[k]["weights"], dtype=np.float32)
        r = p_cuml[-1] * u[sel]
        idx = np.searchsorted(p_cuml, r, side="right")
        want_th = fits[k]["thetas"][idx] + np.einsum(
            "bkl,bl->bk", fits[k]["chols"][idx], z[sel])
        away = np.abs(p_cuml[None, :] - r[:, None]).min(axis=1) > 1e-6
        assert away.mean() > 0.99
        np.testing.assert_allclose(th[sel][away], want_th[away],
                                   rtol=1e-5, atol=1e-5)
        if DIMS[k] < D_MAX:
            assert (th[sel][:, 1:] == 0).all()


def test_local_logpdf_models_matches_jax():
    """K14's K > 1 mode: each lane under its own model's mixture, the JAX
    package's ``device_logpdf`` with that model's params."""
    fits, params = _fits_and_params(6)
    rng = np.random.default_rng(7)
    q = rng.normal([0.5, 1.0], [0.3, 0.5], size=(600, D_MAX)).astype(
        np.float32)
    m = rng.integers(0, K, 600).astype(np.int32)
    q[m == 0, 1] = 0.0
    got = local_logpdf.models(torch.from_numpy(q), torch.from_numpy(m),
                              params).numpy()
    for k in range(K):
        jp = jax.tree.map(jnp.asarray, fits[k])
        ref = np.asarray(jax.vmap(lambda th: JLocal.device_logpdf(th, jp))(
            jnp.asarray(q[m == k])))
        np.testing.assert_allclose(got[m == k], ref, atol=1e-4, rtol=1e-5)
        one = {key: params[key][k] for key in ("thetas", "precs", "lconst",
                                               "weights")}
        np.testing.assert_array_equal(
            got[m == k], local_logpdf(torch.from_numpy(q[m == k]),
                                      one).numpy())


def test_convert_carries_stacked_local_params():
    fits, params = _fits_and_params(8)
    assert set(params) == {"thetas", "weights", "chols", "precs", "logdets",
                           "cdf", "lconst", "dims"}
    np.testing.assert_array_equal(params["dims"].numpy(), DIMS)
    for k in range(K):
        one = convert.local_transition_params(fits[k], device="cpu")
        for key in ("thetas", "chols", "cdf", "lconst"):
            assert torch.equal(params[key][k], one[key])
    jcarry = (tuple(fits), np.array([np.log(0.5), np.log(0.5), -np.inf],
                                    np.float32),
              np.array([True, True, False]), np.ones(2, np.float32),
              np.float32(0.4), (np.float32(np.inf), np.float32(0.0),
                                np.float32(1.0)), np.asarray(False))
    carry = convert.carry(jcarry, device="cpu",
                          mpk=jmpk.ModelPerturbationKernel(K).device_params())
    assert torch.equal(carry.trans_params["chols"], params["chols"])
    one = convert.carry(((fits[1],),) + jcarry[1:], device="cpu")
    assert set(one.trans_params) == {"thetas", "weights", "chols", "precs",
                                     "logdets", "cdf", "lconst", "dim"}


# ----------------------------------------------------------- whole runs
X_OBS = 0.7


def _pair(pkg, seed=8, gens=5, population_size=500):
    """``tests/test_fused.py:903-937``: the tractable pair with two
    LocalTransitions."""
    if pkg == "jax":
        models, priors, _an = jmsel.tractable_pair()
        abc = jpt.ABCSMC(
            models, priors, jpt.PNormDistance(p=2),
            population_size=population_size, eps=jpt.MedianEpsilon(),
            seed=seed, fused_generations=4,
            transitions=[jpt.LocalTransition(), jpt.LocalTransition()])
        assert abc._fused_chunk_capable()
    else:
        models, priors, _an = tmsel.tractable_pair()
        abc = tpt.ABCSMC(
            models, priors, tpt.PNormDistance(p=2),
            population_size=population_size, eps=tpt.MedianEpsilon(),
            seed=seed, fused_generations=4,
            transitions=[tpt.LocalTransition(), tpt.LocalTransition()],
            device="cpu")
    abc.new("sqlite://", {"x": X_OBS})
    return abc.run(max_nr_populations=gens)


@pytest.fixture(scope="module")
def pair_runs():
    return {pkg: _pair(pkg) for pkg in ("port", "jax")}


def _p0(h):
    return float(h.get_model_probabilities(h.max_t)["p"].get(0, 0.0))


def test_local_pair_matches_the_exact_and_jax(pair_runs):
    exact = float(tmsel.tractable_pair()[2](X_OBS)[0])
    h, jh = pair_runs["port"], pair_runs["jax"]
    assert h.n_populations == jh.n_populations == 5
    assert _p0(h) == pytest.approx(exact, abs=0.15)
    assert _p0(h) == pytest.approx(_p0(jh), abs=0.15)
    eps = h.get_all_populations().query("t >= 0")["epsilon"].to_numpy()
    eps_j = jh.get_all_populations().query("t >= 0")["epsilon"].to_numpy()
    np.testing.assert_allclose(eps, eps_j, rtol=0.25)


def test_local_pair_populations_hold_each_models_draws(pair_runs):
    """Each generation after the first holds particles of both models,
    each model's within its prior's support (the K > 1 local draws redraw
    against that model's prior)."""
    h = pair_runs["port"]
    for t in range(1, h.max_t + 1):
        probs = h.get_model_probabilities(t)["p"]
        assert set(probs.index) == {0, 1}
        for mk in (0, 1):
            df, w = h.get_distribution(mk, t)
            assert len(df) > 0 and np.isfinite(df.to_numpy()).all()
            assert w.sum() == pytest.approx(1.0)


def test_adaptive_n_over_two_local_models():
    """The tractable pair under a bounded AdaptivePopulationSize: each
    generation's n_next is the next generation's n, within the bounds, and
    K16's LocalTransition mode weighted the two models' CVs."""
    aps = tpt.AdaptivePopulationSize(300, mean_cv=0.3,
                                      min_population_size=50,
                                      max_population_size=800,
                                      n_bootstrap=4)
    h = _pair("port", seed=3, gens=4, population_size=aps)
    s = h.get_nr_particles_per_population()
    ns = [int(v) for v in s[s.index >= 0]]
    tel = [h.get_telemetry(t) for t in range(len(ns))]
    assert ns[0] == 300 and all(50 <= n <= 800 for n in ns)
    assert [x["n_next"] for x in tel[:-1]] == ns[1:]
    assert all(x["k16_probes"] >= 1 and x["k16_cv_max"] > 0
               for x in tel[:-1])
    assert sum(_p0_t(h, t) for t in range(len(ns))) > 0


def _p0_t(h, t):
    return float(h.get_model_probabilities(t)["p"].get(0, 0.0))


# ---------------------------------------------------------------- gates
@pytest.mark.parametrize("what", ["differing", "mixed", "stochastic",
                                  "segmented", "unbounded"])
def test_what_stays_unported_raises(what):
    models, priors, _an = tmsel.tractable_pair()
    kw = dict(transitions=[tpt.LocalTransition(), tpt.LocalTransition()])
    if what == "differing":
        kw["transitions"] = [tpt.LocalTransition(k_fraction=0.25),
                             tpt.LocalTransition(k_fraction=0.5)]
        match = "transitions differ.*item 16"
    elif what == "mixed":
        kw["transitions"] = [tpt.LocalTransition(),
                             tpt.MultivariateNormalTransition()]
        match = "transitions differ.*item 16"
    elif what == "unbounded":
        kw["population_size"] = tpt.AdaptivePopulationSize(150)
        match = "unbounded max_population_size.*item 16"
    elif what == "stochastic":
        # noisy ABC runs one model at a constant size; a list of sizes
        # takes the JAX package's host loop (its stochastic gate)
        with pytest.raises(NotImplementedError,
                           match="LocalTransition with a StochasticAcceptor"
                                 ".*constant population size.*item 16"):
            tpt.ABCSMC(gaussian.make_mean_only_model(),
                       gaussian.mean_only_prior(),
                       tpt.IndependentNormalKernel(var=[0.1]),
                       population_size=tpt.ListPopulationSize([100, 200]),
                       eps=tpt.Temperature(),
                       acceptor=tpt.StochasticAcceptor(),
                       transitions=tpt.LocalTransition(), device="cpu")
        return
    else:
        # segmented early reject runs two LocalTransitions; a sharded
        # segmented run stays unported, as with the MVN transition
        seg = [gillespie.make_birth_death_model(n_leaps=100, n_obs=20,
                                                segments=5, x0=x0)
               for x0 in (10, 20)]
        with pytest.raises(NotImplementedError,
                           match="segmented early reject in a sharded "
                                 "run.*item 13"):
            tpt.ABCSMC(seg, [gillespie.birth_death_prior()] * 2,
                       tpt.PNormDistance(p=2), population_size=64,
                       eps=tpt.MedianEpsilon(), sharded=8, device="cpu",
                       **kw)
        return
    with pytest.raises(NotImplementedError, match=match):
        tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2), device="cpu",
                   **kw)


def test_identical_local_transitions_are_admitted_as_jax_admits_them():
    """The JAX package's fused gate takes two LocalTransitions of one
    configuration under a constant, listed or bounded adaptive size, and
    so does the port."""
    models, priors, _an = jmsel.tractable_pair()
    for ps in (500, jpt.ListPopulationSize([200, 300]),
               jpt.AdaptivePopulationSize(200, max_population_size=400)):
        abc = jpt.ABCSMC(models, priors, jpt.PNormDistance(p=2),
                         population_size=ps,
                         transitions=[jpt.LocalTransition(k_fraction=0.3),
                                      jpt.LocalTransition(k_fraction=0.3)])
        assert abc._fused_chunk_capable()
    t_models, t_priors, _an = tmsel.tractable_pair()
    for ps in (500, tpt.ListPopulationSize([200, 300]),
               tpt.AdaptivePopulationSize(200, max_population_size=400)):
        tpt.ABCSMC(t_models, t_priors, tpt.PNormDistance(p=2),
                   population_size=ps,
                   transitions=[tpt.LocalTransition(k_fraction=0.3),
                                tpt.LocalTransition(k_fraction=0.3)],
                   device="cpu")
