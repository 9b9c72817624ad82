"""Port parity for the prior families (K2's prior mode and log-density):
every family of ``pyabc_tpu.core.random_variables`` and
``LowerBoundDecorator``, held to the JAX package's float32 functions on
the same numpy points; the plain draws held to scipy's law and to the JAX
samplers' means; whole runs under family priors against quadrature and
against the JAX package's fused runs."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import importlib  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.stats as st  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.core import random_variables as jrv  # noqa: E402
from pyabc_tpu.models import lotka_volterra as jlv  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core import random_variables as trv  # noqa: E402
from pyabc_tpu_torch.core.random_variables import stacked_arrays  # noqa
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.models import lotka_volterra as tlv  # noqa: E402

torch.set_num_threads(1)
#: the module (``kernels.propose`` is the wrapper object)
kprop = importlib.import_module("pyabc_tpu_torch.kernels.propose")

#: (family, scipy args): every family, and the samplers' other branches
#: (gamma's boost, beta's log space, BTRS, PTRS)
CASES = {
    "norm": ("norm", 0.5, 2.0), "uniform": ("uniform", -1.0, 3.0),
    "lognorm": ("lognorm", 0.5, 0.0, 1.5), "expon": ("expon", 0.2, 1.5),
    "gamma": ("gamma", 2.0, 0.0, 0.5), "gamma_a1": ("gamma", 1.0),
    "gamma_small": ("gamma", 0.3), "beta": ("beta", 2.0, 3.0, -1.0, 3.0),
    "beta_small": ("beta", 0.2, 0.3), "laplace": ("laplace", 0.0, 1.0),
    "cauchy": ("cauchy", 0.0, 1.0), "t": ("t", 3.0, 0.0, 1.0),
    "t_heavy": ("t", 1.5, 1.0, 2.0),
    "truncnorm": ("truncnorm", -1.0, 2.0, 0.0, 1.0),
    "truncnorm_tail": ("truncnorm", 4.0, math.inf, 0.0, 1.0),
    "randint": ("randint", 2, 9), "binom": ("binom", 20, 0.3),
    "binom_btrs": ("binom", 100, 0.7), "poisson": ("poisson", 3.0),
    "poisson_ptrs": ("poisson", 40.0), "nbinom": ("nbinom", 5.0, 0.4),
}
DISCRETE = ("randint", "binom", "poisson", "nbinom")
#: log-densities: rel 1e-5 + abs 1e-5, 1e-4 where gammaln of a large
#: argument enters (the far tails of the discrete families)
TOL = {"binom_btrs": 1e-4, "poisson_ptrs": 1e-4, "poisson": 1e-4,
       "nbinom": 1e-4, "binom": 1e-4}
B = 65536
#: the KS statistic's critical value at level 0.001 is KS_C / sqrt(n)
KS_C = 1.9495


def _points(spec) -> np.ndarray:
    """float32 points: inside, each support edge and its neighbours,
    outside, far tails, off-integer points, 0."""
    law = getattr(st, spec[0])(*spec[1:])
    lo, hi = law.support()
    pts = [law.ppf(np.linspace(0.001, 0.999, 41)),
           [0.0, -1e-3, 1e-3, -50.0, 50.0, -1e4, 1e4, 0.5, 2.5, 7.25,
            -0.3, 3.7]]
    for b in (lo, hi):
        if np.isfinite(b):
            pts.append([b, b - 0.25, b + 0.25, np.nextafter(b, -np.inf),
                        np.nextafter(b, np.inf)])
    p = np.concatenate([np.asarray(v, np.float64) for v in pts])
    return np.unique(p[np.isfinite(p)].astype(np.float32))


def _assert_logpdf(got, ref, tol):
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], ref[~fin])
    np.testing.assert_allclose(got[fin], ref[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logpdf_matches_jax(case):
    spec = CASES[case]
    x = _points(spec)
    ref = np.asarray(jrv.RV(*spec).logpdf(jnp.asarray(x)))
    got = trv.RV(*spec).logpdf(torch.from_numpy(x)).numpy()
    _assert_logpdf(got, ref, TOL.get(case, 1e-5))


@pytest.mark.parametrize("case", ["norm", "gamma", "lognorm", "poisson",
                                  "beta", "truncnorm"])
def test_lower_bound_logpdf_matches_jax(case):
    spec = CASES[case]
    bound = float(getattr(st, spec[0])(*spec[1:]).ppf(0.3))
    x = np.concatenate([_points(spec), np.float32([bound]),
                        np.nextafter(np.float32([bound]), np.float32(9))])
    ref = np.asarray(jrv.LowerBoundDecorator(jrv.RV(*spec), bound).logpdf(
        jnp.asarray(x)))
    got = trv.LowerBoundDecorator(trv.RV(*spec), bound).logpdf(
        torch.from_numpy(x)).numpy()
    _assert_logpdf(got, ref, TOL.get(case, 1e-5))
    assert np.isneginf(got[x <= np.float32(bound)]).all()


def _law(spec):
    if spec[0] == "bound":
        _f, loc, scale = spec[1]
        return st.truncnorm((spec[2] - loc) / scale, np.inf, loc, scale)
    return getattr(st, spec[0])(*spec[1:])


def _law_check(x, spec):
    law = _law(spec)
    if spec[0] in DISCRETE:
        assert np.all(x == np.round(x))
        ks = np.arange(int(law.ppf(1e-4)), int(law.ppf(1 - 1e-4)) + 1)
        pmf = law.pmf(ks)
        ks, pmf = ks[pmf >= 1e-3], pmf[pmf >= 1e-3]
        emp = np.array([(x == k).mean() for k in ks])
        se = np.sqrt(pmf * (1 - pmf) / len(x))
        assert np.max(np.abs(emp - pmf) / se) < 4.0
    else:
        assert st.kstest(x, law.cdf).statistic < KS_C / math.sqrt(len(x))


def _plain_draw(rv, seed=7):
    prior = tpt.Distribution(x=rv).arrays("cpu")
    stream = philox.PhiloxStream(seed, 0, philox.PRIOR, 256,
                                 torch.zeros(4, dtype=torch.int32))
    theta, logpri, valid = kprop.propose(stream, B, prior)
    assert bool(valid.all())
    return theta[:, 0].double().numpy(), logpri


def _location_gap(x, y, heavy):
    """(difference, standard error) of the means, or of the medians for
    heavy tails (se from the density at the pooled median)."""
    if not heavy:
        return (x.mean() - y.mean(),
                math.sqrt(x.var() / len(x) + y.var() / len(y)))
    both = np.concatenate([x, y])
    med = np.median(both)
    h = 0.05 * (np.quantile(both, 0.75) - np.quantile(both, 0.25))
    dens = np.mean(np.abs(both - med) < h) / (2 * h)
    se1 = 1.0 / (2 * dens * math.sqrt(len(x)))
    return np.median(x) - np.median(y), math.hypot(se1, se1)


@pytest.mark.parametrize("case", sorted(set(CASES) - {"truncnorm_tail"})
                         + ["bound"])
def test_plain_draws_follow_the_law(case):
    """The plain sampler's 65536 draws against scipy (the KS statistic
    under its 0.001 critical value, or the pmf within 4 se) and their mean
    (median for cauchy and t with df < 2) against the JAX sampler's within
    4 se."""
    spec = (("bound", ("norm", 0.1, 0.1), 0.0) if case == "bound"
            else CASES[case])
    if case == "bound":
        rv = tpt.LowerBoundDecorator(tpt.RV(*spec[1]), spec[2])
        jrv_ = jrv.LowerBoundDecorator(jrv.RV(*spec[1]), spec[2])
    else:
        rv, jrv_ = tpt.RV(*spec), jrv.RV(*spec)
    x, logpri = _plain_draw(rv)
    _law_check(x, spec)
    # beta(0.2, 0.3) rounds some draws onto 0 or 1 in float32, where the
    # density (open support, as JAX's) is 0: the JAX sampler does the same
    edge = ((x == 0) | (x == 1)) & (case == "beta_small")
    assert np.array_equal(torch.isfinite(logpri).numpy(), ~edge)
    assert np.mean(edge) < 0.05
    if case == "bound":
        assert (x > spec[2]).all()
    ref = np.asarray(jrv_.rvs(jax.random.key(3), (B,)), np.float64)
    gap, se = _location_gap(x, ref, case in ("cauchy", "t_heavy"))
    assert abs(gap) < 4 * se, (gap, se)


def test_norm_uniform_draws_keep_their_bits():
    """Norm and uniform keep their blocks: the plain draws of a mixed
    norm/uniform prior are the values they had before the other families
    came. Three rows are pinned bit for bit; the Philox words the 4096
    lanes read are pinned as integers, the uniform dimensions bit for bit
    against numpy's float32 over those words, and the normal dimensions and
    the log-densities within a few float32 ulps of a float64 numpy
    Box-Muller and log-density over the same words (PyTorch does not
    promise its CPU log, cos and sin to the bit across machines)."""
    prior = tpt.Distribution(
        a=tpt.RV("norm", 0.5, 2.0), b=tpt.RV("uniform", -1.0, 3.0),
        c=tpt.RV("uniform", 0.0, 1.0), d=tpt.RV("norm", -3.0, 0.1),
        e=tpt.RV("uniform", 2.0, 0.5)).arrays("cpu")
    ctr = torch.zeros(4, dtype=torch.int32)
    ctr[1] = 5
    stream = philox.PhiloxStream(1234, 3, philox.PRIOR, 256, ctr)
    theta = kprop.prior_draw_plain(stream, torch.arange(8), prior, 5)
    want = [
        ["0x1.93f1e00000000p-6", "0x1.127ff80000000p+0",
         "0x1.1c888a0000000p-1", "-0x1.80a9dc0000000p+1",
         "0x1.3a68ea0000000p+1"],
        ["0x1.6e8db40000000p+1", "0x1.a1a3540000000p+0",
         "0x1.3620a60000000p-1", "-0x1.6cb7080000000p+1",
         "0x1.2522ca0000000p+1"],
        ["-0x1.b6035c0000000p+0", "0x1.308a000000000p-2",
         "0x1.812c560000000p-1", "-0x1.7318780000000p+1",
         "0x1.23aa4e0000000p+1"]]
    assert [[v.hex() for v in row] for row in
            theta[:3].double().tolist()] == want
    th, lp, _v = kprop.propose_plain(stream, 4096, prior)
    # d = 5: the normals from blocks 0 and 1, the uniforms from blocks 2
    # and 3 (word k % 4 of block 2 + k // 4 for dimension k)
    words = torch.stack(philox.lane_blocks(
        stream, torch.arange(4096)[:, None], torch.arange(4)[None, :]), -1)
    assert words[0].reshape(-1).tolist() == [
        3786625806, 1410928205, 1001691917, 2168253033, 1352456638,
        3005295402, 61820846, 2935097805, 950233546, 2966770536,
        2386838920, 3173116770, 3919816182, 3775558147, 1963455768,
        148739992]
    assert int(words.sum()) == 140947446865563
    w = words.numpy()
    u = ((w >> 9).astype(np.float64) + 0.5) * 2.0 ** -23  # exact in float32
    loc, scale = (prior[k].numpy() for k in ("loc", "scale"))
    th = th.numpy()
    # the uniforms: word 1 and 2 of block 2, word 0 of block 3, float32
    for k, (blk, wd) in ((1, (2, 1)), (2, (2, 2)), (4, (3, 0))):
        ref = loc[k] + scale[k] * u[:, blk, wd].astype(np.float32)
        assert np.array_equal(th[:, k], ref.astype(np.float32))
    # the normals: block 0's pair 0 (cos) and pair 1 (sin); the angle is
    # the float32 product of 2 pi in float32 and the uniform, as the draw
    two_pi = np.float32(philox.TWO_PI_F32)
    for k, pair, trig in ((0, 0, np.cos), (3, 1, np.sin)):
        u1, u2 = u[:, 0, 2 * pair], u[:, 0, 2 * pair + 1]
        angle = (two_pi * u2.astype(np.float32)).astype(np.float64)
        z = np.sqrt(-2.0 * np.log(u1)) * trig(angle)
        ref = loc[k] + scale[k] * z
        tol = (2 * np.spacing(np.abs(ref).astype(np.float32))
               + 8 * 2.0 ** -23 * scale[k] * np.abs(z))
        assert (np.abs(th[:, k] - ref) <= tol).all(), k
    # the log-densities of the drawn values, float64
    x = th.astype(np.float64)
    terms = np.stack(
        [-0.5 * ((x[:, k] - loc[k]) / scale[k]) ** 2 - np.log(scale[k])
         - 0.5 * np.log(2 * np.pi) if k in (0, 3)
         else np.full(len(x), -np.log(scale[k])) for k in range(5)], 1)
    ref = terms.sum(1)
    tol = 8 * 2.0 ** -23 * np.abs(terms).sum(1)
    assert (np.abs(lp.numpy() - ref) <= tol).all()


def test_draw_layout_is_disjoint():
    """Norm and uniform read blocks below 2 ceil(32 / 4) = 16; draw number
    q owns blocks [q << 12, (q + 1) << 12); the draw numbers of 32
    dimensions, 9 decorator draws and their second sequences never meet."""
    q = [1 + kprop.N_BOUND_DRAWS * k + j for k in range(kprop.MAX_DIM)
         for j in range(kprop.N_BOUND_DRAWS)]
    q2 = [v + kprop.SECOND_DRAW for v in q]
    assert len(set(q) | set(q2)) == 2 * len(q)
    assert min(q) << philox.POISSON_BLOCK_BITS >= 2 * (kprop.MAX_DIM // 4)
    assert max(q2) < philox.POISSON_MAX_DRAWS


@pytest.mark.parametrize("what", ["gamma", "btrs", "inversion"])
def test_sampler_caps(what, monkeypatch):
    """A lane that exhausts its sampler's cap gives the documented value:
    gamma d V with V = 1 (alpha = 2: d = 2 - 1/3), BTRS -1, inversion the
    count it reached less one (-1 at a cap of 0)."""
    lanes = torch.arange(64)
    q = torch.full((64,), 1, dtype=torch.int64)
    stream = philox.PhiloxStream(5, 0, philox.PRIOR, 256,
                                 torch.zeros(4, dtype=torch.int32))
    if what == "gamma":
        monkeypatch.setattr(kprop, "GAMMA_MAX_ATTEMPTS", 0)
        x = kprop.gamma_plain(stream, lanes, q, torch.full((64,), 2.0))
        assert torch.equal(x, torch.full((64,), 2.0 - kprop.ONE_THIRD_F32))
        return
    monkeypatch.setattr(kprop, "BINOM_MAX_UNIFORMS", 0)
    n, p = (100.0, 0.3) if what == "btrs" else (10.0, 0.3)
    x = kprop.binom_plain(stream, lanes, q, torch.full((64,), n),
                          torch.full((64,), p))
    assert torch.equal(x, torch.full((64,), -1.0))


def test_construction_matches_jax():
    with pytest.raises(ValueError) as port_err:
        trv.RV("lognorm", 0.5, 1.0)
    with pytest.raises(ValueError) as jax_err:
        jrv.RV("lognorm", 0.5, 1.0)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as port_err:
        trv.RV("weibull", 1.0)
    with pytest.raises(ValueError) as jax_err:
        jrv.RV("weibull", 1.0)
    assert str(port_err.value) == str(jax_err.value)
    assert sorted(trv.FAMILIES) == sorted(jrv._FAMILIES)
    for spec in CASES.values():
        a, b = trv.RV(*spec), jrv.RV(*spec)
        assert (a.discrete, a.args, a.kwargs, repr(a), a._params) == (
            b.discrete, b.args, b.kwargs, repr(b), b._params)
    kw = trv.RV("gamma", 2.0, scale=0.5)
    assert repr(kw) == repr(jrv.RV("gamma", 2.0, scale=0.5))
    assert kw.kwargs == {"scale": 0.5} and kw._params == (2.0, 0.0, 0.5)
    assert trv.LowerBoundDecorator(trv.RV("poisson", 2.0), 0).discrete


class _UserRV(trv.RVBase):
    pass


class _JaxUserRV(jrv.RVBase):
    def rvs(self, key, shape=()):
        return jax.random.normal(key, shape)

    def logpdf(self, x):
        return -0.5 * x * x


@pytest.mark.parametrize("what", ["nested", "user", "scipy"])
def test_host_only_components_raise(what):
    """A decorator of a decorator, a user RVBase and ScipyRV are refused
    before launch, in the port and in ``convert.prior_from_jax``."""
    port = {"nested": lambda: trv.LowerBoundDecorator(
                trv.LowerBoundDecorator(trv.RV("norm"), 0.0), 1.0),
            "user": _UserRV, "scipy": lambda: trv.ScipyRV(st.norm())}[what]
    jax_ = {"nested": lambda: jrv.LowerBoundDecorator(
                jrv.LowerBoundDecorator(jrv.RV("norm"), 0.0), 1.0),
            "user": _JaxUserRV, "scipy": lambda: jrv.ScipyRV(st.norm())}[what]
    with pytest.raises(NotImplementedError, match="item 16"):
        tpt.Distribution(a=tpt.RV("norm"), b=port())
    with pytest.raises(NotImplementedError, match="item 16"):
        convert.prior_from_jax(jpt.Distribution(a=jax_()))


def _mixed(pkg):
    return pkg.Distribution(
        a=pkg.RV("gamma", 2.0, 0.0, 0.75), b=pkg.RV("lognorm", 0.8, 0, 0.12),
        c=pkg.RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
        d=pkg.LowerBoundDecorator(pkg.RV("norm", 0.1, 0.1), 0.0),
        e=pkg.RV("binom", 20, 0.3), f=pkg.RV("nbinom", 5, 0.4),
        g=pkg.RV("t", 3, 0, 1), h=pkg.RV("beta", 2, 3, -1, 3),
        i=pkg.RV("poisson", 3.0), j=pkg.RV("randint", 2, 9),
        k=pkg.RV("cauchy", 0, 1), l=pkg.RV("laplace", 0, 1),
        m=pkg.RV("expon", 0.2, 1.5), n=pkg.RV("uniform", -1, 3))


def test_prior_from_jax_logpdf_array():
    jd = _mixed(jpt)
    pd = convert.prior_from_jax(jd)
    assert repr(pd.rv_map["d"]) == "LowerBoundDecorator(RV('norm', 0.1, " \
                                   "0.1), 0.0)"
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4096, 14)) * 1.5 + 1.0).astype(np.float32)
    x[:, 4:6] = np.round(x[:, 4:6] * 3)
    x[:2048, 8] = np.abs(x[:2048, 8])
    ref = np.asarray(jax.vmap(jd.logpdf_array)(jnp.asarray(x)))
    got = pd.logpdf_array(torch.from_numpy(x)).numpy()
    assert np.isfinite(ref).any()
    _assert_logpdf(got, ref, 1e-4)


def test_stacked_families_logpdf():
    """K > 1: the plain log-density of each lane under its model's row of
    ``stacked_arrays`` is that model's own ``logpdf_array``."""
    priors = [tpt.Distribution(a=tpt.RV("gamma", 2.0, 0.0, 0.75),
                               b=tpt.RV("lognorm", 0.8, 0.0, 0.12)),
              tpt.Distribution(a=tpt.RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
                               b=tpt.LowerBoundDecorator(
                                   tpt.RV("norm", 0.1, 0.1), 0.0),
                               c=tpt.RV("poisson", 3.0))]
    arrays = stacked_arrays(priors, "cpu")
    assert arrays["families"] and arrays["par"].shape == (2, 3, 6)
    rng = np.random.default_rng(1)
    theta = torch.from_numpy(np.abs(rng.normal(size=(512, 3)))
                             .astype(np.float32))
    m = torch.from_numpy(rng.integers(0, 2, 512))
    lane = {k: arrays[k][m] for k in trv.PRIOR_KEYS}
    real = torch.arange(3)[None, :] < arrays["dims"][m][:, None]
    got = kprop.prior_logpdf_plain(theta, lane, real)
    for k, p in enumerate(priors):
        sel = m == k
        want = p.logpdf_array(theta[sel, :p.dim])
        assert torch.equal(torch.isfinite(got[sel]), torch.isfinite(want))
        fin = torch.isfinite(want)
        torch.testing.assert_close(got[sel][fin], want[fin], rtol=1e-6,
                                   atol=1e-6)
    # the K > 1 plain draw keeps each model's family, padded entries 0
    stream = philox.PhiloxStream(2, 0, philox.PRIOR, 256,
                                 torch.zeros(4, dtype=torch.int32))
    th, lp, valid, mm = kprop.propose.models(
        stream, 4096, arrays, torch.tensor([0.5, 0.5]))
    assert bool(valid.all()) and bool(torch.isfinite(lp).all())
    m0 = mm == 0
    assert bool((th[m0, 2] == 0).all()) and bool((th[m0, :2] > 0).all())
    assert bool((th[~m0, 1] > 0).all())
    assert bool((th[~m0, 2] == torch.round(th[~m0, 2])).all())


# --------------------------------------------------------- whole runs
NOISE_VAR, X_OBS = 0.09, 0.8
ANCHOR_SEEDS = (0, 1, 2)


def _exact_posterior_mean(law):
    grid = np.linspace(-20, 20, 400001)
    post = law.pdf(grid) * st.norm(grid, math.sqrt(NOISE_VAR)).pdf(X_OBS)
    return float(np.sum(post * grid) / post.sum())


def _anchor(pkg, seed):
    prior = pkg.Distribution(theta=pkg.RV("gamma", 2.0, 0.0, 0.5))
    if pkg is jpt:
        @jpt.JaxModel.from_function(["theta"], name="det")
        def model(key, theta):
            return {"x": theta[0]}
        extra = {}
    else:
        model = tpt.TorchModel(lambda theta, gen: {"x": theta[:, 0]},
                               ["theta"], name="det")
        extra = {"device": "cpu"}
    abc = pkg.ABCSMC(model, prior, pkg.IndependentNormalKernel(
        var=[NOISE_VAR]), population_size=500, eps=pkg.Temperature(),
        acceptor=pkg.StochasticAcceptor(), seed=seed, **extra)
    abc.new("sqlite://", {"x": X_OBS})
    h = abc.run(max_nr_populations=7)
    temps = h.get_all_populations()["epsilon"].to_numpy()[1:]
    assert temps[-1] == 1.0
    df, w = h.get_distribution()
    return float(np.sum(w * df["theta"]))


def test_gamma_prior_noisy_anchor():
    """The noisy anchor (x = theta, IndependentNormalKernel(var 0.09),
    x_obs 0.8, Temperature to T = 1) under RV("gamma", 2, 0, 0.5): the
    weighted population at T = 1 is the exact posterior; the port's seed
    mean within 4 se of quadrature and of the JAX package's fused runs."""
    exact = _exact_posterior_mean(st.gamma(2.0, 0.0, 0.5))
    port = np.array([_anchor(tpt, s) for s in ANCHOR_SEEDS])
    ref = np.array([_anchor(jpt, s) for s in ANCHOR_SEEDS])
    se_p = port.std(ddof=1) / math.sqrt(len(port))
    se_j = ref.std(ddof=1) / math.sqrt(len(ref))
    # one seed's posterior mean at pop 500: sd about 0.28 / sqrt(ESS)
    floor = 0.3 / math.sqrt(500 * len(ANCHOR_SEEDS))
    assert abs(port.mean() - exact) < 4 * max(se_p, floor)
    assert abs(port.mean() - ref.mean()) < 4 * max(math.hypot(se_p, se_j),
                                                    floor)


def _lv_prior(pkg):
    return pkg.Distribution(
        alpha=pkg.RV("gamma", 2.0, 0.0, 0.75),
        beta=pkg.RV("lognorm", 0.8, 0.0, 0.12),
        gamma=pkg.RV("truncnorm", -1.5, 1.5, 1.5, 1.0),
        delta=pkg.LowerBoundDecorator(pkg.RV("norm", 0.1, 0.1), 0.0))


#: test_torch_aggregate_runs.py's adaptive tolerance on the seed-mean
#: epsilon trail
EPS_RTOL_ADAPTIVE = 0.25


def _lv_trail(pkg, seed):
    obs = jlv.observed_data(seed=123)
    model = (jlv.make_lv_model() if pkg is jpt else tlv.make_lv_model())
    extra = {} if pkg is jpt else {"device": "cpu"}
    abc = pkg.ABCSMC(model, _lv_prior(pkg), pkg.AdaptivePNormDistance(p=2),
                     population_size=256, eps=pkg.MedianEpsilon(),
                     seed=seed, **extra)
    abc.new("sqlite://", obs, store_sum_stats=False)
    h = abc.run(max_nr_populations=4)
    assert h.n_populations == 4
    return h.get_all_populations()["epsilon"].to_numpy()[1:]


def test_lv_family_prior_trails_track_jax():
    """LV config 2 at pop 256, 4 generations, under the card leg's prior
    (gamma, lognorm, truncnorm, a norm bounded at 0): the seed-mean
    epsilon trail of the port within the adaptive tolerance of the JAX
    package's."""
    port = np.stack([_lv_trail(tpt, s) for s in (0, 1, 2)])
    ref = np.stack([_lv_trail(jpt, s) for s in (0, 1, 2)])
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port.mean(0), ref.mean(0),
                               rtol=EPS_RTOL_ADAPTIVE)


# ------------------------------------------- the other paths K2 feeds
def test_local_transition_under_a_family_prior():
    """K2's local mode scores every family: LocalTransition runs LV under
    the card leg's prior, every particle inside the prior's support."""
    abc = tpt.ABCSMC(tlv.make_lv_model(), _lv_prior(tpt),
                     tpt.AdaptivePNormDistance(p=2), population_size=300,
                     transitions=tpt.LocalTransition(k_fraction=0.25),
                     seed=4, device="cpu")
    abc.new("sqlite://", jlv.observed_data(seed=123), store_sum_stats=False)
    h = abc.run(max_nr_populations=3)
    assert h.n_populations == 3
    df, w = h.get_distribution(0, 2)
    assert (df["delta"] > 0).all() and (df["alpha"] > 0).all()
    assert ((df["gamma"] >= 0) & (df["gamma"] <= 3)).all()
    assert np.isfinite(w).all()


def test_segmented_round_under_a_family_prior():
    """The segmented round takes K2's family draws: birth-death in 5
    segments under a truncnorm and a bounded norm, early reject on and
    off bit-identical in every generation."""
    from pyabc_tpu.models import gillespie as jg
    from pyabc_tpu_torch.models import gillespie as tg

    small = dict(n_leaps=100, n_obs=20)
    prior = tpt.Distribution(
        log_b=tpt.RV("truncnorm", -2.0, 2.0, 0.0, 0.5),
        log_d=tpt.LowerBoundDecorator(tpt.RV("norm", -1.0, 0.5), -2.0))
    obs = {k: np.asarray(v) for k, v in
           jg.observed_birth_death(segments=5, **small).items()}
    hs = []
    for early in ("auto", False):
        abc = tpt.ABCSMC(tg.make_birth_death_model(segments=5, **small),
                         prior, tpt.PNormDistance(p=2), population_size=64,
                         eps=tpt.MedianEpsilon(), seed=11,
                         early_reject=early, fused_generations=3,
                         device="cpu")
        abc.new("sqlite://", obs)
        hs.append(abc.run(max_nr_populations=3))
    h_on, h_off = hs
    assert h_on.max_t == h_off.max_t == 2
    assert sum(h_on.get_telemetry(t)["retired_early"] for t in range(3)) > 0
    for t in range(3):
        df1, w1 = h_on.get_distribution(m=0, t=t)
        df2, w2 = h_off.get_distribution(m=0, t=t)
        assert np.array_equal(df1.to_numpy(), df2.to_numpy())
        assert np.array_equal(w1, w2)
        assert (df1["log_d"] > -2.0).all()
        assert ((df1["log_b"] >= -1.0) & (df1["log_b"] <= 1.0)).all()


def test_card_leg_observation_is_the_jax_packages():
    """chip_smoke.py's LV families leg feeds the JAX package's observation
    of bench.py's LV config 2 (observed_data(seed=123)), held as
    constants since the card's machine has no JAX."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ref = jlv.observed_data(seed=123)
    for k, v in smoke.LV_JAX_OBS.items():
        np.testing.assert_array_equal(np.asarray(v, np.float32),
                                      np.asarray(ref[k], np.float32))


@pytest.mark.parametrize("case", ["norm", "uniform"])
def test_cdf_matches_jax(case):
    spec = CASES[case]
    x = _points(spec)
    ref = np.asarray(jrv.RV(*spec).cdf(jnp.asarray(x)))
    got = trv.RV(*spec).cdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError):
        trv.RV("gamma", 2.0).cdf(torch.from_numpy(x))
