"""Linear learned summary statistics (K23's fit and transform, K18's
transformed bound): the port's modules against the JAX package on the CPU.

The same numpy inputs go through the JAX package's ``ops/fit.py``
(``ridge_fit``, ``keep_if_finite``, ``linear_bound_prepare``,
``linear_bound_fns``), its host ``LinearPredictor`` and its
``PNormDistance(sumstat=...).device_fn``, and through the port's plain
versions of K23 and K18's transformed mode (``linear_bound_fns`` against
K18's plain fold and test); each configuration the port
refuses is shown beside the JAX package's own verdict on it.
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
from pyabc_tpu.models import gillespie as jg  # noqa: E402
from pyabc_tpu.ops import fit as jfit  # noqa: E402
from pyabc_tpu.sumstat import device as jdevice  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.linear_bound import linear_bound  # noqa: E402
from pyabc_tpu_torch.kernels.linear_sumstat import (  # noqa: E402
    linear_accept, transform_rows)
from pyabc_tpu_torch.kernels.ridge_fit import ridge_fit  # noqa: E402
from pyabc_tpu_torch.kernels.segment_round import (  # noqa: E402
    BOUND_RTOL, bound_limit, lin_bound_fold, lin_exceeds, segment_round)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.ops import fit as tfit  # noqa: E402
from pyabc_tpu_torch.sumstat import device as tdevice  # noqa: E402

torch.set_num_threads(1)

#: the JAX suite's tolerance between its float32 fit and the float64 host
#: fit (test_sumstat_device.py:101-122); the port fits in float64
FIT_RTOL = FIT_ATOL = 2e-4
#: the host fits: the same float64 numpy arithmetic
HOST_RTOL = 1e-10
#: projectors: float64 eigenvectors (port) against float32 eigh (JAX)
PROJ_ATOL = 1e-5
#: distances of learned statistics: S-term dot products in another order
D_RTOL = 1e-5
KEYS = ("W", "b", "mu", "sd")


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ------------------------------------------------------------ K23's fit
def _fit_case(case):
    rng = np.random.default_rng(7)
    n, S, d = 300, 6, 2
    x = rng.normal(size=(n, S)) * np.arange(1, S + 1) + 50.0
    y = x[:, :d] @ rng.normal(size=(d, d)) * 0.01 + 0.1 * rng.normal(
        size=(n, d))
    w = rng.random(n) + 0.1
    mask = np.ones(n, bool)
    if case == "masked":
        mask[211:] = False
        x[211:] = rng.normal(size=(n - 211, S)) * 1e4  # never read
    if case == "constant column":
        x[:, 3] = 7.25  # sd 0: the floor keeps it at 1
    return x, y, w, mask


@pytest.mark.parametrize("case", ["plain", "masked", "constant column"])
def test_ridge_fit_matches_jax(case):
    x, y, w, mask = _fit_case(case)
    ref = jax.jit(jfit.ridge_fit, static_argnames="alpha")(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(w, jnp.float32), jnp.asarray(mask), alpha=0.5)
    got = tfit.ridge_fit(_f32(x), _f32(y), _f32(w), torch.as_tensor(mask),
                         0.5)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=FIT_RTOL, atol=FIT_ATOL,
                                   err_msg=k)
    if case == "masked":
        # the masked rows contribute nothing: the fit on the kept rows
        alone = tfit.ridge_fit(_f32(x[:211]), _f32(y[:211]), _f32(w[:211]),
                               torch.ones(211, dtype=torch.bool), 0.5)
        for k in KEYS:
            np.testing.assert_allclose(got[k].numpy(), alone[k].numpy(),
                                       rtol=1e-6, atol=1e-7)
    if case == "constant column":
        assert got["sd"][3] == 1.0


def _counters(n_acc, n_target):
    c = torch.zeros(5, dtype=torch.int32)
    c[0], c[4] = n_acc, n_target
    return c


def _old(S, C):
    return {"W": torch.full((S, C), 0.5), "b": torch.full((C,), -1.0),
            "mu": torch.zeros(S), "sd": torch.ones(S)}


@pytest.mark.parametrize("n_acc,n_target,need,fits", [
    (250, 211, 8, True),    # complete generation: the first 211 rows
    (150, 211, 8, False),   # incomplete: the old parameters
    (250, 211, 212, False),  # complete, below need
])
def test_ridge_fit_decision_on_device(n_acc, n_target, need, fits):
    """K23's plain version decides from the counters as the kernel does:
    n_keep = min(n_acc, n_target) rows, a complete generation, need."""
    x, y, w, _mask = _fit_case("plain")
    x, y, w = _f32(x), _f32(y), _f32(w)
    old = _old(6, 2)
    params, flags = ridge_fit(x, y, w, _counters(n_acc, n_target), old,
                              alpha=0.5, need=need)
    assert flags.tolist() == [1, int(fits)]
    if fits:
        mask = torch.arange(300) < 211
        ref = tfit.ridge_fit(x, y, w, mask, 0.5)
        for k in KEYS:
            assert torch.equal(params[k], ref[k])
    else:
        for k in KEYS:
            assert torch.equal(params[k], old[k])


@pytest.mark.parametrize("poison", ["nan row", "inf weight"])
def test_keep_if_finite_keeps_old(poison):
    """A blown fit keeps the old parameters (``ok`` 0), as the JAX
    guard."""
    x, y, w, _mask = _fit_case("plain")
    if poison == "nan row":
        x[5, 2] = np.nan
    else:
        w[9] = np.inf
    old = _old(6, 2)
    params, flags = ridge_fit(_f32(x), _f32(y), _f32(w), _counters(300, 300),
                              old, alpha=0.5, need=8)
    assert flags.tolist() == [0, 1]
    for k in KEYS:
        assert torch.equal(params[k], old[k])
    jold = {k: jnp.asarray(v.numpy()) for k, v in old.items()}
    jnew = {k: jnp.full_like(v, jnp.nan) for k, v in jold.items()}
    _, ok = jfit.keep_if_finite(jnew, jold)
    tnew = {k: torch.full_like(v, math.nan) for k, v in old.items()}
    kept, tok = tfit.keep_if_finite(tnew, old)
    assert bool(tok) is bool(ok) is False
    assert all(torch.equal(kept[k], old[k]) for k in KEYS)


# --------------------------------------------------------- the host fit
@pytest.mark.parametrize("normalize,weighted", [(True, True), (True, False),
                                                (False, True)])
def test_linear_predictor_host_fit_matches_jax(normalize, weighted):
    x, y, w, _mask = _fit_case("plain")
    w = w if weighted else None
    jp = jpt.LinearPredictor(alpha=0.3, normalize=normalize)
    tp = tpt.LinearPredictor(alpha=0.3, normalize=normalize)
    jp.fit(x, y, w)
    tp.fit(x, y, w)
    for k in ("_W", "_b", "_mu", "_sd"):
        np.testing.assert_allclose(getattr(tp, k), getattr(jp, k),
                                   rtol=HOST_RTOL)
    np.testing.assert_allclose(tp.predict(x[:17]), jp.predict(x[:17]),
                               rtol=HOST_RTOL)
    np.testing.assert_allclose(tp.predict(x[3]), jp.predict(x[3]),
                               rtol=HOST_RTOL)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mirror_round_trip_bit_identical(pkg):
    """mirror_fitted_params stores the fetched float32 values; the
    predictor's device parameters give them back bit for bit."""
    rng = np.random.default_rng(3)
    host = {"W": rng.normal(size=(6, 2)).astype(np.float32),
            "b": rng.normal(size=2).astype(np.float32),
            "mu": rng.normal(size=6).astype(np.float32),
            "sd": rng.random(6).astype(np.float32) + 0.5}
    mod = jpt if pkg == "jax" else tpt
    dist = mod.PNormDistance(p=2, sumstat=mod.PredictorSumstat(
        mod.LinearPredictor()))
    (jdevice if pkg == "jax" else tdevice).mirror_fitted_params(dist, host,
                                                                5)
    back = dist.sumstat.predictor.device_params()
    assert dist.sumstat._last_fit_t == 5 and dist.sumstat._out_dim == 2
    for k in KEYS:
        assert np.array_equal(np.asarray(back[k]), host[k])


# ---------------------------------------------------------- K18's bound
def _bound_case(case):
    rng = np.random.default_rng(11)
    if case == "network map":  # the network SIR's: 4 segments of 4 rows
        n_seg, seg, C = 4, 4, 2
    elif case == "rank deficient":  # one row a segment, C' 3
        n_seg, seg, C = 5, 1, 3
    else:  # full rank until the last segment
        n_seg, seg, C = 3, 2, 2
    S = n_seg * seg
    imap = rng.permutation(S).reshape(n_seg, seg).astype(np.int32)
    params = {"W": rng.normal(size=(S, C)), "b": rng.normal(size=C),
              "mu": rng.normal(size=S), "sd": rng.random(S) + 0.5}
    w = rng.random(C) + 0.5
    return imap, {k: v.astype(np.float32) for k, v in params.items()}, \
        w.astype(np.float32)


def _null_counts(proj):
    return np.rint(np.trace(np.asarray(proj, np.float64), axis1=1,
                            axis2=2)).astype(int)


@pytest.mark.parametrize("case", ["network map", "rank deficient",
                                  "full rank"])
def test_linear_bound_prepare_matches_jax(case):
    imap, params, w = _bound_case(case)
    ref = jfit.linear_bound_prepare(
        {"w": jnp.asarray(w), "ss": {k: jnp.asarray(v)
                                     for k, v in params.items()}}, imap)
    got = linear_bound(_f32(w), {k: _f32(v) for k, v in params.items()},
                       torch.as_tensor(imap))
    np.testing.assert_allclose(got["At"].numpy(), np.asarray(ref["At"]),
                               rtol=1e-6)
    counts = _null_counts(got["proj"])
    assert counts.tolist() == _null_counts(ref["proj"]).tolist()
    # the last suffix is empty: the projector is the identity
    np.testing.assert_allclose(got["proj"][-1].numpy(), np.eye(w.size),
                               atol=PROJ_ATOL)
    np.testing.assert_allclose(got["proj"].numpy(), np.asarray(ref["proj"]),
                               atol=PROJ_ATOL)
    if case == "rank deficient":
        # a true null space appears before the end
        assert counts[-2] > 0 and counts[0] == 0


@pytest.mark.parametrize("case", ["network map", "rank deficient"])
def test_linear_bound_fns_match_jax(case):
    """The bound's step and retirement test on random prefixes: K18's
    plain fold and test (``lin_bound_fold``, ``lin_exceeds``, segment by
    segment, in order, over the port's operands) against the JAX
    ``linear_bound_fns`` closures over the JAX operands."""
    imap, params, w = _bound_case(case)
    rng = np.random.default_rng(5)
    B, S, C = 64, imap.size, w.size
    x0 = rng.normal(size=S).astype(np.float32)
    vals = (x0 + rng.normal(size=(B, S)) * 0.3).astype(np.float32)
    jbp = jfit.linear_bound_prepare(
        {"w": jnp.asarray(w), "ss": {k: jnp.asarray(v)
                                     for k, v in params.items()}}, imap)
    tbp = tfit.linear_bound_prepare(_f32(w), {k: _f32(v) for k, v in
                                              params.items()}, imap)
    jf = jfit.linear_bound_fns(BOUND_RTOL, C)
    jacc = jnp.zeros((B, C + 1), jnp.float32)
    kacc = torch.zeros(B, C)
    thr = np.float32(0.4)
    lim = bound_limit(torch.tensor(thr), 2.0)
    retired = 0
    for j in range(imap.shape[0]):
        cols = imap[j]
        jacc = jax.vmap(lambda a, v: jf["step"](a, v, cols, jnp.asarray(x0),
                                                jbp))(
            jacc, jnp.asarray(vals[:, cols]))
        kacc = lin_bound_fold(kacc, _f32(vals[:, cols]), _f32(x0[cols]),
                              tbp["At"][torch.as_tensor(cols).long()])
        np.testing.assert_allclose(kacc.numpy(), np.asarray(jacc)[:, :-1],
                                   rtol=1e-5, atol=1e-6)
        assert np.array_equal(np.asarray(jacc)[:, -1], np.full(B, j + 1.0))
        jex = np.asarray(jax.vmap(lambda a: jf["exceeds"](a, thr, jbp))(
            jacc))
        kex = lin_exceeds(kacc, tbp["proj"][j + 1], lim).numpy()
        assert np.array_equal(kex, jex)
        retired += int(kex.sum()) if j < imap.shape[0] - 1 else 0
    if case == "rank deficient":
        # a true null space before the end: some prefixes prove the bound
        assert retired > 0


# ----------------------------------------------- K23's transform, accept
def _fitted_pair(S=6, C=2, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, S)) * np.arange(1, S + 1) + 20.0
    y = x[:, :C] * 0.05 + 0.2 * rng.normal(size=(400, C))
    jp = jpt.LinearPredictor(alpha=1.0)
    jp.fit(x, y)
    return jp, convert.predictor_from_jax(jp), rng


@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_linear_accept_matches_jax_device_fn(p):
    jp, tp, rng = _fitted_pair()
    S, B = 6, 128
    spec = {"s": np.zeros(S)}
    jd = jpt.PNormDistance(p=p, sumstat=jpt.PredictorSumstat(jp))
    jd.initialize(0, x_0=spec)
    jd.sumstat._out_dim = 2
    x0 = (rng.normal(size=S) * 3 + 20).astype(np.float32)
    ss = (x0 + rng.normal(size=(B, S)) * 5).astype(np.float32)
    params = jd.device_params(1)
    fn = jd.device_fn(jd.spec)
    ref = np.asarray(jax.vmap(lambda r: fn(r, jnp.asarray(x0), params))(
        jnp.asarray(ss)))
    tparams = tp.device_params()
    w = torch.ones(2)
    eps = torch.tensor(float(np.median(ref)))
    valid = torch.ones(B, dtype=torch.bool)
    valid[7] = False
    d, acc, lw = linear_accept(_f32(ss), _f32(x0), tparams, w, eps, valid,
                               p=p)
    np.testing.assert_allclose(d.numpy(), ref, rtol=D_RTOL)
    assert torch.equal(acc, valid & (d <= eps))
    assert lw[7] == -math.inf and (lw[valid] == 0).all()
    assert torch.equal(linear_accept.values(_f32(ss), _f32(x0), tparams, w,
                                            p=p), d)
    np.testing.assert_allclose(
        transform_rows(_f32(ss), tparams).numpy(),
        np.asarray(jax.vmap(lambda r: jp.device_predict(
            r, params["ss"]))(jnp.asarray(ss))), rtol=D_RTOL, atol=1e-6)


def test_predictor_from_jax_predicts_the_same():
    jp, tp, rng = _fitted_pair(S=9, C=3, seed=4)
    x = rng.normal(size=(50, 9)) * 4 + 20.0
    np.testing.assert_allclose(tp.predict(x), jp.predict(x), rtol=1e-12)
    got = transform_rows(_f32(x), tp.device_params()).numpy()
    np.testing.assert_allclose(got, jp.predict(x), rtol=1e-6, atol=1e-6)
    js = jpt.PredictorSumstat(jp, min_samples=40)
    js._out_dim, js._last_fit_t = 3, 4
    ts = convert.sumstat_from_jax(js)
    assert (ts._out_dim, ts._last_fit_t, ts.min_samples) == (3, 4, 40)
    assert ts.predictor.fitted and ts.predictor.alpha == jp.alpha


# ------------------------------------------------- plans and refusals
def _jax_plan(sumstat):
    d = jpt.PNormDistance(p=2, sumstat=sumstat)
    return jdevice.device_fit_plan(d, total_size=16, d_max=2)


def _port_plan(sumstat):
    d = tpt.PNormDistance(p=2, sumstat=sumstat)
    return tdevice.device_fit_plan(d, total_size=16, d_max=2)


#: each predictor or transform the port refuses, with a fragment of the
#: JAX package's reason (None: the JAX package fuses it, the port not yet:
#: an MLP wider than K23's MLP kernels hold, refused when the run starts)
REFUSED = {
    "MLPPredictor": (lambda m: m.PredictorSumstat(m.MLPPredictor(
        hidden=(256,))), None),
    "LassoPredictor": (lambda m: m.PredictorSumstat(m.LassoPredictor()),
                       "ISTA proximal loop"),
    "GPPredictor": (lambda m: m.PredictorSumstat(m.GPPredictor()),
                    "subsamples training points"),
    "ModelSelectionPredictor": (
        lambda m: m.PredictorSumstat(m.ModelSelectionPredictor(
            [m.LinearPredictor()])), "cross-validated winner"),
    "fit_every 2": (lambda m: m.PredictorSumstat(m.LinearPredictor(),
                                                 fit_every=2),
                    "fit_every=2 host cadence"),
    "IdentitySumstat": (lambda m: m.IdentitySumstat(), "fixed transform"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refusals_carry_the_jax_reason(what):
    make, fragment = REFUSED[what]
    jplan, jreason = _jax_plan(make(jpt))
    tplan, treason = _port_plan(make(tpt))
    assert (jplan is None) == (tplan is None) == (fragment is not None)
    assert treason == jreason
    with pytest.raises(NotImplementedError, match="item 14") as err:
        abc = tpt.ABCSMC(tg.make_birth_death_model(), tg.birth_death_prior(),
                         tpt.PNormDistance(p=2, sumstat=make(tpt)),
                         population_size=64, device="cpu")
        abc.new("sqlite://", tg.observed_birth_death())
        abc.run(max_nr_populations=1)
    if fragment is not None:
        assert fragment in str(err.value)


def test_linear_plan_and_several_models():
    jplan, _r = _jax_plan(jpt.PredictorSumstat(jpt.LinearPredictor(0.5)))
    tplan, _r = _port_plan(tpt.PredictorSumstat(tpt.LinearPredictor(0.5)))
    assert tplan == jplan == {"kind": "linear", "out_dim": 2, "need": 18,
                              "alpha": 0.5}
    models = [tg.make_birth_death_model(segments=5) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="item 14"):
        tpt.ABCSMC(models, [tg.birth_death_prior()] * 2,
                   tpt.PNormDistance(p=2, sumstat=tpt.PredictorSumstat(
                       tpt.LinearPredictor())), population_size=64,
                   device="cpu")


@pytest.mark.parametrize("how", ["host fit", "sumstat_from_jax"])
def test_fitted_predictor_refused_before_launch(how):
    """A predictor fitted before the run is refused before launch and
    left as it was (generation 0 runs under the identity on the port)."""
    jp, tp, _rng = _fitted_pair(S=20, C=2, seed=6)
    if how == "host fit":
        ss = tpt.PredictorSumstat(tp)
    else:
        js = jpt.PredictorSumstat(jp)
        js._out_dim, js._last_fit_t = 2, 3
        ss = convert.sumstat_from_jax(js)
    before = {k: v.copy() for k, v in (("W", ss.predictor._W),
                                       ("mu", ss.predictor._mu))}
    abc = _seg_abc(tpt, tpt.PNormDistance(p=2, sumstat=ss))
    with pytest.raises(NotImplementedError, match="item 14"):
        abc.run(max_nr_populations=2)
    assert abc.history.max_t < 0
    assert all(np.array_equal(getattr(ss.predictor, f"_{k}"), v)
               for k, v in before.items())


def _seg_abc(pkg, dist, **kw):
    model = (jg if pkg is jpt else tg).make_birth_death_model(
        n_leaps=100, n_obs=20, segments=5)
    prior = (jg if pkg is jpt else tg).birth_death_prior()
    extra = {} if pkg is jpt else {"device": "cpu"}
    abc = pkg.ABCSMC(model, prior, dist, population_size=64,
                     eps=pkg.MedianEpsilon(), **kw, **extra)
    abc.new("sqlite://", (jg if pkg is jpt else tg).observed_birth_death(
        n_leaps=100, n_obs=20, segments=5))
    return abc


#: the early-reject gate's outcomes: admitted (None) or the JAX reason
GATES = {
    "linear p 2": (lambda m: m.PNormDistance(
        p=2, sumstat=m.PredictorSumstat(m.LinearPredictor())), None),
    "adaptive": (lambda m: m.AdaptivePNormDistance(
        p=2, sumstat=m.PredictorSumstat(m.LinearPredictor())),
        "AdaptivePNormDistance has no monotone prefix bound"),
    "linear p 1": (lambda m: m.PNormDistance(
        p=1, sumstat=m.PredictorSumstat(m.LinearPredictor())),
        "PNormDistance has no monotone prefix bound"),
    # an MLP transform mixes the columns with no per-prefix bound: the
    # JAX gate's device_bound_fn answer comes before its MLP branch
    "mlp p 2": (lambda m: m.PNormDistance(
        p=2, sumstat=m.PredictorSumstat(m.MLPPredictor())),
        "PNormDistance has no monotone prefix bound"),
}


@pytest.mark.parametrize("what", sorted(GATES))
def test_early_reject_gate_matches_jax(what):
    make, fragment = GATES[what]
    jdist = make(jpt)
    jabc = _seg_abc(jpt, jdist)
    jdist.initialize(0, x_0=jabc.x_0)
    # the JAX gate runs after the generation-0 seed fit
    jdist.sumstat.predictor._W = np.zeros((20, 2))
    jdist.sumstat._out_dim = 2
    adaptive = what == "adaptive"
    jreason = jabc._early_reject_incapable_reason(
        adaptive=adaptive, stochastic=False, sumstat_mode=True,
        sharded_n=None)
    tabc = _seg_abc(tpt, make(tpt))
    tabc.spec = SumStatSpec(tabc.x_0)
    tabc.distance_function.initialize(tabc.spec)
    treason = tabc._early_reject_incapable_reason(adaptive=adaptive,
                                                  stochastic=False)
    assert (jreason is None) == (treason is None) == (fragment is None)
    if fragment is not None:
        assert fragment in jreason and treason == jreason


def test_segment_round_linear_mode_counts_and_keep():
    """K18's plain transformed mode on a birth-death round under a C' 8
    transform (4 values a segment, so the last segment's rows leave a null
    space): slots retire, and only where v^T P_j v proves the final
    distance above eps; the statistics of kept slots equal the
    unsegmented round's."""
    model = tg.make_birth_death_model(n_leaps=100, n_obs=20, segments=5)
    obs = tg.observed_birth_death(n_leaps=100, n_obs=20, segments=5)
    spec = SumStatSpec(obs)
    imap = model.index_map(spec, "cpu")
    rng = np.random.default_rng(2)
    B, S = 256, spec.total_size
    theta = _f32(np.stack([rng.uniform(-1, 1, B), rng.uniform(-2, 0, B)],
                          1))
    valid = torch.ones(B, dtype=torch.bool)
    C = 8
    x0 = _f32(spec.flatten_host(obs))
    params = {"W": _f32(rng.normal(size=(S, C))), "b": torch.zeros(C),
              "mu": x0, "sd": torch.full((S,), 10.0)}
    w = torch.ones(C)
    counters = torch.zeros(4, dtype=torch.int32)
    stream = philox.PhiloxStream(0, 1, philox.SIM_NOISE, 256, counters)
    bp = linear_bound(w, params, imap)
    full = segment_round(model.segmented, theta, valid, stream, imap=imap,
                         x0=x0, w=w, p=2.0, eps=torch.tensor(1e30),
                         width=S, seg_ctr=torch.zeros(4, dtype=torch.int64),
                         lin=bp)
    d_full = linear_accept.values(full[0], x0, params, w, p=2.0)
    eps = torch.quantile(d_full, 0.3)
    ctr = torch.zeros(4, dtype=torch.int64)
    ss, keep = segment_round(model.segmented, theta, valid, stream,
                             imap=imap, x0=x0, w=w, p=2.0, eps=eps, width=S,
                             seg_ctr=ctr, lin=bp)
    # sound: a retired slot is rejected by the full test
    assert bool((d_full[~keep] > eps).all())
    assert torch.equal(ss[keep], full[0][keep])
    assert int(ctr[0]) == int((~keep).sum()) > 0 and int(ctr[2]) == B


# -------------------------------------------------- the C entry points
def _entry_points():
    """(name, argument count) of every ``extern "C"`` entry point in the
    kernels' sources, read from the declarations."""
    from pyabc_tpu_torch.kernels._build import CSRC

    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for head in text.split('extern "C" int ')[1:]:
            name, rest = head.split("(", 1)
            depth, args = 1, ""
            for ch in rest:
                depth += (ch == "(") - (ch == ")")
                if depth == 0:
                    break
                args += ch
            out[name.strip()] = len([a for a in args.split(",")
                                     if a.strip()])
    return out


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_argtypes_match_the_source(name):
    """ctypes converts each argument by the declared argtypes: a missing
    or short entry would pass pointers as 32-bit ints."""
    from pyabc_tpu_torch.kernels._build import SIGNATURES

    assert len(SIGNATURES[name]) == _entry_points()[name]
