"""The host-refit mode of learned summary statistics: the port's modules
against the JAX package on the CPU.

The same numpy rows go through both packages' host fits (``LassoPredictor``
by ISTA, ``GPPredictor``'s seeded subsample, median heuristic and kernel
solve, ``ModelSelectionPredictor``'s split, candidates and winner), which
are float64 numpy in both, so the parameters agree to float64 rounding.
The GP transform's plain version (``ops/fit.py::gp_predict``, the GP
kernel's plain twin) and its accept against the JAX package's
``GPPredictor.device_predict`` inside ``PNormDistance.device_fn`` with a
``UniformAcceptor``; ``IdentitySumstat``'s functions against the JAX
package's; the resolver of a host-refit run's transform kind; the
configurations the port still refuses; and the kind switch of a model
selection between two boundaries in a whole run.
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
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.inference.context import LEARNED_KERNELS  # noqa: E402
from pyabc_tpu_torch.kernels.gp_sumstat import (  # noqa: E402
    MAX_S, caps_reason, distance_scale, gp_accept, transform_rows,
    transform_scale)
from pyabc_tpu_torch.models import gillespie as tg  # noqa: E402
from pyabc_tpu_torch.ops import fit as tfit  # noqa: E402
from pyabc_tpu_torch.sumstat import device as tdevice  # noqa: E402
from pyabc_tpu_torch.sumstat.base import (expand_rows,  # noqa: E402
                                          identity_accept)

torch.set_num_threads(1)

#: the host fits: the same float64 numpy arithmetic in both packages
HOST_RTOL = HOST_ATOL = 1e-10
#: the GP transform in float32: S-term sums, the kernel's exp and the
#: cap-term sum k @ a in another order than XLA's, held relative to the
#: transform's scale (sum |k a| + |ymu|: the sum cancels where alpha is
#: small, so the result itself is no scale)
GP_RTOL = 1e-5


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _rows(n=300, S=6, C=2, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, S)) * np.arange(1, S + 1) + 20.0
    y = x[:, :C] * 0.05 + 0.2 * rng.normal(size=(n, C))
    w = rng.random(n) + 0.1
    return x, y, w, rng


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=HOST_RTOL,
                               atol=HOST_ATOL)


# ------------------------------------------------------------ host fits
@pytest.mark.parametrize("alpha,normalize", [(0.01, True), (0.2, True),
                                             (0.01, False)])
def test_lasso_fit_matches_jax(alpha, normalize):
    x, y, w, _rng = _rows()
    jp = jpt.LassoPredictor(alpha=alpha, n_iter=300, normalize=normalize)
    tp = tpt.LassoPredictor(alpha=alpha, n_iter=300, normalize=normalize)
    jp.fit(x, y, w)
    tp.fit(x, y, w)
    for k in ("_W", "_b", "_mu", "_sd"):
        _close(getattr(tp, k), getattr(jp, k))
    _close(tp.predict(x[:9]), jp.predict(x[:9]))
    # the L1 threshold zeroes coefficients in both the same way
    assert np.array_equal(tp._W == 0, jp._W == 0)


@pytest.mark.parametrize("n,length_scale", [(700, None), (300, None),
                                            (300, 1.7)])
def test_gp_fit_matches_jax(n, length_scale):
    """The seeded subsample (above cap), the median heuristic's length
    scale, the kernel solve and the zero padding to cap."""
    x, y, w, _rng = _rows(n=n)
    jp = jpt.GPPredictor(length_scale=length_scale, cap=512, seed=3)
    tp = tpt.GPPredictor(length_scale=length_scale, cap=512, seed=3)
    jp.fit(x, y, w)
    tp.fit(x, y, w)
    assert tp._ls == jp._ls
    for k in ("_X", "_alpha_w", "_mu", "_sd", "_ymu"):
        _close(getattr(tp, k), getattr(jp, k))
    used = min(n, 512)
    # the subsample: the same rows, standardized, in the same order
    idx = (np.random.default_rng(3).choice(n, 512, replace=False)
           if n > 512 else np.arange(n))
    assert np.array_equal(tp._X[:used], (x[idx] - tp._mu) / tp._sd)
    assert not tp._X[used:].any() and not tp._alpha_w[used:].any()
    _close(tp.predict(x[:300]), jp.predict(x[:300]))
    _close(tp.predict(x[4]), jp.predict(x[4]))


def _candidates(m):
    return [m.LinearPredictor(alpha=1.0), m.GPPredictor(alpha=0.1),
            m.LassoPredictor(alpha=0.05)]


@pytest.mark.parametrize("seed", [0, 5])
def test_model_selection_fit_matches_jax(seed):
    """The validation split, each candidate's fit and score, and the winner
    refit on every row: the same winner and parameters."""
    x, y, w, _rng = _rows(n=240, seed=seed + 11)
    jp = jpt.ModelSelectionPredictor(_candidates(jpt), split=0.25,
                                     seed=seed)
    tp = tpt.ModelSelectionPredictor(_candidates(tpt), split=0.25,
                                     seed=seed)
    jp.fit(x, y, w)
    tp.fit(x, y, w)
    assert type(tp.chosen).__name__ == type(jp.chosen).__name__
    assert tp.fitted and jp.fitted
    _close(tp.predict(x[:20]), jp.predict(x[:20]))
    for k, v in vars(jp.chosen).items():
        if isinstance(v, np.ndarray):
            _close(getattr(tp.chosen, k), v)


def _failing(m):
    """A candidate whose fit raises, in the package ``m``'s predictor
    interface."""

    class Bad(m.LinearPredictor):
        def fit(self, x, y, w=None):
            raise ValueError("singular")

    return Bad()


def test_model_selection_skips_failing_candidates_as_jax():
    x, y, w, _rng = _rows(n=120)
    tp = tpt.ModelSelectionPredictor([_failing(tpt),
                                      tpt.LinearPredictor()])
    tp.fit(x, y, w)
    assert type(tp.chosen) is tpt.LinearPredictor
    errors = []
    for m in (jpt, tpt):
        with pytest.raises(RuntimeError) as err:
            m.ModelSelectionPredictor([_failing(m), _failing(m)]).fit(x, y)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith("no predictor could be fit; candidates "
                                "failed with: Bad: ValueError('singular')")


# ------------------------------------------------------- the GP transform
def _gp_pair(n=300, S=6, C=2, seed=9, cap=512, **kw):
    x, y, _w, rng = _rows(n=n, S=S, C=C, seed=seed)
    jp = jpt.GPPredictor(cap=cap, **kw)
    jp.fit(x, y)
    return jp, convert.predictor_from_jax(jp), x, rng


@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_gp_accept_matches_jax_device_fn(p):
    jp, tp, x, rng = _gp_pair()
    S, B = 6, 160
    jd = jpt.PNormDistance(p=p, sumstat=jpt.PredictorSumstat(jp))
    jd.initialize(0, x_0={"s": np.zeros(S)})
    jd.sumstat._out_dim = 2
    x0 = (x[0] + rng.normal(size=S)).astype(np.float32)
    ss = (x[:B] + rng.normal(size=(B, S))).astype(np.float32)
    params = jd.device_params(1)
    fn = jd.device_fn(jd.spec)
    ref = np.asarray(jax.vmap(lambda r: fn(r, jnp.asarray(x0), params))(
        jnp.asarray(ss)))
    tparams = tp.device_params()
    w = torch.ones(2)
    eps = torch.tensor(float(np.median(ref)))
    valid = torch.ones(B, dtype=torch.bool)
    valid[5] = False
    d, acc, lw = gp_accept(_f32(ss), _f32(x0), tparams, w, eps, valid, p=p)
    scale = distance_scale(_f32(ss), _f32(x0), tparams, w).numpy()
    assert (np.abs(d.numpy() - ref) <= GP_RTOL * scale).all()
    assert torch.equal(acc, valid & (d <= eps))
    assert lw[5] == -math.inf and (lw[valid] == 0).all()
    assert torch.equal(gp_accept.values(_f32(ss), _f32(x0), tparams, w,
                                        p=p), d)
    jt = np.asarray(jax.vmap(lambda r: jp.device_predict(r, params["ss"]))(
        jnp.asarray(ss)))
    got = transform_rows(_f32(ss), tparams).numpy()
    assert (np.abs(got - jt)
            <= GP_RTOL * transform_scale(_f32(ss), tparams).numpy()).all()
    # the float64 host predict of the same fit is the reference of both
    host = jp.predict(ss.astype(np.float64))
    assert (np.abs(got - host)
            <= GP_RTOL * transform_scale(_f32(ss), tparams).numpy()).all()


def test_gp_transform_below_cap_and_in_blocks():
    """A fit on fewer rows than cap (the padded points add nothing), and
    the plain version's blocks of rows: the same bits as one block."""
    jp, tp, x, _rng = _gp_pair(n=90, cap=128, seed=4)
    params = tp.device_params()
    assert not params["a"][90:].any()
    rows = _f32(x[:70])
    whole = tfit.gp_predict(rows, params)
    old = tfit.GP_CHUNK_ELEMS
    try:
        tfit.GP_CHUNK_ELEMS = params["X"].numel() * 7
        assert torch.equal(tfit.gp_predict(rows, params), whole)
    finally:
        tfit.GP_CHUNK_ELEMS = old
    trimmed = {**params, "X": params["X"][:90].contiguous(),
               "a": params["a"][:90].contiguous()}
    np.testing.assert_allclose(tfit.gp_predict(rows, trimmed).numpy(),
                               whole.numpy(), rtol=1e-6)
    np.testing.assert_allclose(whole.numpy(), jp.predict(x[:70]),
                               rtol=1e-4, atol=1e-5)
    assert tfit.gp_predict(rows[0], params).shape == (2,)


def test_gp_caps():
    assert caps_reason(128, 2) is None and caps_reason(MAX_S, 8) is None
    assert "GP kernel stages" in caps_reason(MAX_S + 1, 2)
    assert "features" in caps_reason(16, 9)
    tp = _gp_pair()[1]
    params = tp.device_params()
    with pytest.raises(ValueError, match="features"):
        gp_accept._operands({**params, "a": torch.zeros(512, 9)}, 6)


# ------------------------------------------------------ IdentitySumstat
TRAFOS = (lambda x: x, lambda x: x ** 2, lambda x: 0.5 * x + 1.0)


@pytest.mark.parametrize("p", [1.0, 2.0])
def test_identity_trafos_match_jax(p):
    rng = np.random.default_rng(2)
    S, B = 5, 64
    x0 = rng.normal(size=S).astype(np.float32)
    ss = (x0 + rng.normal(size=(B, S))).astype(np.float32)
    js = jpt.IdentitySumstat(trafos=list(TRAFOS))
    ts = tpt.IdentitySumstat(trafos=list(TRAFOS))
    assert ts.out_dim(S) == js.out_dim(S) == 3 * S
    np.testing.assert_allclose(ts(ss), js(ss), rtol=1e-12)
    jfn = js.device_fn(None)
    jrows = np.asarray(jax.vmap(lambda r: jfn(r, ()))(jnp.asarray(ss)))
    params = ts.device_params()
    rows = expand_rows(_f32(ss), params)
    np.testing.assert_allclose(rows.numpy(), jrows, rtol=1e-6)
    jd = jpt.PNormDistance(p=p, sumstat=jpt.IdentitySumstat(list(TRAFOS)))
    jd.initialize(0, x_0={"s": np.zeros(S)})
    fn = jd.device_fn(jd.spec)
    jparams = jd.device_params(0)
    ref = np.asarray(jax.vmap(lambda r: fn(r, jnp.asarray(x0), jparams))(
        jnp.asarray(ss)))
    w = torch.ones(3 * S)
    d, acc, _lw = identity_accept(_f32(ss), _f32(x0), params, w,
                                  torch.tensor(1.0),
                                  torch.ones(B, dtype=torch.bool), p=p)
    np.testing.assert_allclose(d.numpy(), ref, rtol=1e-5)
    assert torch.equal(identity_accept.values(_f32(ss), _f32(x0), params,
                                              w, p=p), d)
    # without functions: the raw rows, the plain p-norm's distances
    assert expand_rows(_f32(ss), None) is not None
    assert tpt.IdentitySumstat().device_params() is None


# --------------------------------------------------------- the resolver
def test_transform_kind_follows_the_fit():
    x, y, w, _rng = _rows(n=200)
    kinds = {}
    for name, pred in (("linear", tpt.LinearPredictor()),
                       ("lasso", tpt.LassoPredictor()),
                       ("gp", tpt.GPPredictor()),
                       ("ms", tpt.ModelSelectionPredictor(
                           [tpt.GPPredictor(alpha=0.1)]))):
        ss = tpt.PredictorSumstat(pred)
        before = tdevice.transform_kind(ss)
        ss.update(1, type("Pop", (), {"sumstats": x, "thetas": y,
                                      "weights": w})())
        kinds[name] = (before, tdevice.transform_kind(ss))
    assert kinds == {"linear": ("identity", "linear"),
                     "lasso": ("identity", "linear"),
                     "gp": ("identity", "gp"), "ms": ("identity", "gp")}
    assert tdevice.transform_kind(tpt.IdentitySumstat()) == "identity"
    assert set(LEARNED_KERNELS) == {"linear", "mlp", "gp", "identity"}


# -------------------------------------------------------------- refusals
def _abc(dist, pop=64, models=None, **kw):
    model = tg.make_birth_death_model(n_leaps=100, n_obs=20, segments=5)
    obs = tg.observed_birth_death(n_leaps=100, n_obs=20, segments=5)
    prior = tg.birth_death_prior()
    abc = tpt.ABCSMC(models or model, prior if models is None
                     else [prior] * len(models), dist,
                     population_size=pop, eps=tpt.MedianEpsilon(),
                     device="cpu", **kw)
    abc.new("sqlite://", obs)
    return abc


class _Odd(tpt.LinearPredictor):
    """A user predictor the host-refit mode has no transform kernel for."""


REFUSED = {
    "a GP fitted before the run": (
        lambda: tpt.PredictorSumstat(_gp_pair(S=20)[1]), "fitted before"),
    "a predictor subclass": (
        lambda: tpt.PredictorSumstat(tpt.ModelSelectionPredictor(
            [tpt.ModelSelectionPredictor([tpt.LinearPredictor()])])),
        "predictor ModelSelectionPredictor"),
    "a summary statistic subclass": (
        lambda: type("MySumstat", (tpt.Sumstat,), {})(),
        "summary statistic MySumstat"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_what_stays_refused(what):
    make, fragment = REFUSED[what]
    with pytest.raises(NotImplementedError, match="item 14") as err:
        abc = _abc(tpt.PNormDistance(p=2, sumstat=make()))
        abc.run(max_nr_populations=2)
    assert fragment in str(err.value)


def test_wide_gp_refused_when_the_run_starts():
    """A GP over more statistics than the kernel stages is refused before
    the first launch (the run knows S only then)."""
    obs = {"y": np.zeros(MAX_S + 4)}

    def sim(theta, gen):
        return {"y": theta[:, :1] + torch.randn(theta.shape[0], MAX_S + 4,
                                                generator=gen)}

    abc = tpt.ABCSMC(tpt.TorchModel(sim, ["a"]),
                     tpt.Distribution(a=tpt.RV("norm", 0, 1)),
                     tpt.PNormDistance(p=2, sumstat=tpt.PredictorSumstat(
                         tpt.GPPredictor())), population_size=64,
                     device="cpu")
    abc.new("sqlite://", obs)
    with pytest.raises(NotImplementedError, match="GP kernel stages"):
        abc.run(max_nr_populations=2)
    assert abc.history.max_t < 0


def test_several_models_and_many_parameters_refused():
    models = [tg.make_birth_death_model(segments=5) for _ in range(2)]
    with pytest.raises(NotImplementedError, match="several models"):
        _abc(tpt.PNormDistance(p=2, sumstat=tpt.PredictorSumstat(
            tpt.GPPredictor())), models=models)
    prior = tpt.Distribution(**{f"p{i}": tpt.RV("norm", 0, 1)
                                for i in range(9)})
    with pytest.raises(NotImplementedError, match="9 features"):
        tpt.ABCSMC(tpt.TorchModel(lambda th, g: {"y": th}, list(prior.space
                                                               .names)),
                   prior, tpt.PNormDistance(p=2, sumstat=tpt.PredictorSumstat(
                       tpt.LassoPredictor())), device="cpu")


# --------------------------------------------------- convert and gates
def test_convert_carries_the_host_predictors():
    x, y, w, rng = _rows(n=200, S=5)
    jl = jpt.LassoPredictor(alpha=0.02, n_iter=50)
    jgp = jpt.GPPredictor(alpha=0.1, cap=64, seed=2)
    jms = jpt.ModelSelectionPredictor([jpt.LinearPredictor(), jgp],
                                      split=0.3, seed=1)
    jl.fit(x, y)
    jms.fit(x, y, w)
    for jp in (jl, jgp, jms):
        tp = convert.predictor_from_jax(jp)
        assert type(tp).__name__ == type(jp).__name__
        _close(tp.predict(x[:7]), jp.predict(x[:7]))
    tms = convert.predictor_from_jax(jms)
    assert tms.chosen is tms.predictors[[type(p) for p in jms.predictors]
                                        .index(type(jms.chosen))]
    ts = convert.sumstat_from_jax(jpt.IdentitySumstat(trafos=[abs]))
    assert type(ts) is tpt.IdentitySumstat and ts.trafos == [abs]


#: the early-reject gate of a host-refit run, the JAX package's reason
#: (its gate runs after generation 0's fit)
GATES = {
    "lasso p 2": (lambda m: m.PNormDistance(p=2, sumstat=m.PredictorSumstat(
        m.LassoPredictor())), "learned summary statistics without a "
        "device-fit plan"),
    "fit_every 3": (lambda m: m.PNormDistance(
        p=2, sumstat=m.PredictorSumstat(m.LinearPredictor(), fit_every=3)),
        "fit_every=3 host cadence"),
    "gp p 2": (lambda m: m.PNormDistance(p=2, sumstat=m.PredictorSumstat(
        m.GPPredictor())), "no monotone prefix bound"),
    "identity": (lambda m: m.PNormDistance(p=2, sumstat=m.IdentitySumstat()),
                 "no monotone prefix bound"),
}


@pytest.mark.parametrize("what", sorted(GATES))
def test_host_refit_early_reject_gate_matches_jax(what):
    make, fragment = GATES[what]
    jdist = make(jpt)
    model = jg.make_birth_death_model(n_leaps=100, n_obs=20, segments=5)
    jabc = jpt.ABCSMC(model, jg.birth_death_prior(), jdist,
                      population_size=64, eps=jpt.MedianEpsilon())
    jabc.new("sqlite://", jg.observed_birth_death(n_leaps=100, n_obs=20,
                                                  segments=5))
    jdist.initialize(0, x_0=jabc.x_0)
    ss = jdist.sumstat
    if isinstance(ss, jpt.PredictorSumstat):
        # the JAX gate runs after the generation-0 host fit
        rng = np.random.default_rng(0)
        ss.update(1, type("Pop", (), {
            "sumstats": rng.normal(size=(64, 20)),
            "thetas": rng.normal(size=(64, 2)),
            "weights": np.ones(64)})())
    plan, plan_reason = jpt.sumstat.device.device_fit_plan(
        jdist, total_size=20, d_max=2)
    jreason = jabc._early_reject_incapable_reason(
        adaptive=False, stochastic=False, sumstat_mode=True,
        sharded_n=None)
    if jreason is None and plan is None:
        jreason = plan_reason
    tabc = _abc(make(tpt))
    tabc.spec = SumStatSpec(tabc.x_0)
    tabc.distance_function.initialize(tabc.spec)
    _plan, host = tabc._sumstat_plan(64)
    assert host is not None and host["reason"] == plan_reason
    treason = tabc._early_reject_incapable_reason(adaptive=False,
                                                  stochastic=False)
    assert fragment in jreason and treason == jreason


# --------------------------------------------- a winner changes its kind
class _Alternating(tpt.ModelSelectionPredictor):
    """A model selection whose winner alternates between its candidates
    from one fit to the next (the kind switch between boundaries)."""

    fits = 0

    def fit(self, x, y, w=None):
        super().fit(x, y, w)
        self.chosen = self.predictors[self.fits % len(self.predictors)]
        self.chosen.fit(x, y, w)
        self.fits += 1


@pytest.mark.parametrize("adaptive", [False, True])
def test_winner_switch_between_boundaries(adaptive):
    """The winner's kind changes at every boundary (linear, GP, linear):
    the rounds run the new kind's entries, ``carry.dist_w["ss"]``
    takes the new structure, and the run goes on to the end with finite
    distances and History rows S wide."""
    pred = _Alternating([tpt.LinearPredictor(alpha=1.0),
                         tpt.GPPredictor(alpha=0.1)])
    cls = tpt.AdaptivePNormDistance if adaptive else tpt.PNormDistance
    abc = _abc(cls(p=2, sumstat=tpt.PredictorSumstat(pred)), pop=128,
               fused_generations=2)
    h = abc.run(max_nr_populations=6)
    # three fits: linear (t 1), GP (t 3), linear (t 5)
    assert h.n_populations == 6 and pred.fits == 3
    assert type(pred.chosen) is tpt.LinearPredictor
    refits = [t for t in range(6) if h.get_telemetry(t).get(
        "sumstat_refit")]
    assert refits == [0, 2, 4]
    for t in range(6):
        d = h.get_weighted_distances(t)["distance"].to_numpy()
        assert np.isfinite(d).all()
        assert h.get_weighted_sum_stats(t)[1].shape[1] == 20
