"""Port parity for the noise models (K21a / K21c) and their upper bounds
(K18's noisy mode) against the JAX package's ``distance/kernel.py`` on the
CPU.

For every family and scale the port's plain log-density (the accept
kernel's plain version) is held to the JAX ``device_fn`` on seeded rows
with count edge cases: float32, relative 1e-5 (the same terms summed in
another order; ``lgamma`` against XLA's ``gammaln``), with the -inf masks
exactly equal. The bounds fold the same 10-segment prefixes as the JAX
``device_bound_fn``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.distance import kernel as jkernel  # noqa: E402
import pyabc_tpu_torch as pt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.sumstat_spec import SumStatSpec  # noqa: E402
from pyabc_tpu_torch.kernels import kernel_accept, philox  # noqa: E402
from pyabc_tpu_torch.kernels.kernel_accept import (  # noqa: E402
    MAX_NORMAL_S, accept_uniforms, noise_bound_fold)

torch.set_num_threads(1)

S = 20
LIN = "SCALE_LIN"


def _cov(S=S):
    i = np.arange(S)
    return 4.0 * 0.5 ** np.abs(i[:, None] - i[None, :])


#: (id, JAX kernel factory): every device-compatible noise model and scale
CASES = [
    ("independent_normal", lambda: jkernel.IndependentNormalKernel(
        var=np.linspace(0.5, 9.0, S))),
    ("laplace", lambda: jkernel.IndependentLaplaceKernel(scale=2.0)),
    ("normal", lambda: jkernel.NormalKernel(cov=_cov())),
    ("normal-lin", lambda: jkernel.NormalKernel(cov=_cov(),
                                                ret_scale=LIN)),
    ("binomial", lambda: jkernel.BinomialKernel(p=0.9)),
    ("binomial-lin", lambda: jkernel.BinomialKernel(p=0.9, ret_scale=LIN)),
    ("binomial-p1", lambda: jkernel.BinomialKernel(p=1.0)),
    ("poisson", lambda: jkernel.PoissonKernel()),
    ("poisson-lin", lambda: jkernel.PoissonKernel(ret_scale=LIN)),
    ("negbin", lambda: jkernel.NegativeBinomialKernel(p=0.5)),
    ("negbin-lin", lambda: jkernel.NegativeBinomialKernel(
        p=0.3, ret_scale=LIN)),
    ("negbin-mean", lambda: jkernel.NegativeBinomialKernel(
        p=0.4, parameterization="mean")),
]
IDS = [c[0] for c in CASES]


def _kernels(make, S=S):
    """The JAX kernel and its port (through ``convert.noise_kernel``), both
    initialized on one flat statistic of S entries."""
    jk = make()
    tk = convert.noise_kernel(jk)
    obs = {"x": np.zeros(S)}
    jk.initialize(0, None, obs)
    tk.initialize(SumStatSpec(obs))
    return jk, tk


def _rows(seed, S=S, B=96, edge=False):
    """Seeded simulations and an observation: counts with noise, and count
    edge cases (x = 0, tiny, negative, NaN, huge; half-integers; with
    ``edge`` the observation also holds k = 0, a negative and a
    half-integer entry)."""
    rng = np.random.default_rng(seed)
    x0 = np.round(rng.uniform(0.0, 25.0, S)).astype(np.float32)
    x0[:3] = (0.0, 2.5, 3.5)
    if edge:
        x0[3] = -1.0
    # mostly at or above the observation, so that k <= n in most rows
    x = (x0 + np.abs(rng.normal(0.0, 3.0, (B, S)))).astype(np.float32)
    x[0] = x0                       # at the observation
    x[1] = 0.0                      # n = 0: k > n where k > 0
    x[2] = 1e-12
    x[3, :4] = (-2.0, 0.5, 1.5, 2.5)  # half-integers round to even
    x[4] = 1e4
    x[5, 5] = np.nan
    x[6] = np.round(x0) - 1.0       # k > n by one in every column
    x[7] = np.abs(x[7])
    return x, x0


def _jax_values(jk, x, x0):
    fn = jk.device_fn(jk.spec)
    par = jk.device_params()
    return np.asarray(jax.vmap(lambda r: fn(r, jnp.asarray(x0), par))(
        jnp.asarray(x)))


def _port_values(tk, x, x0, temp=1.0, pdf_norm=0.0, lin=None):
    stream = philox.PhiloxStream(5, 2, philox.ACCEPT, 64,
                                 torch.tensor([0, 3, 0, 0],
                                              dtype=torch.int32))
    lin = tk.ret_scale == LIN if lin is None else lin
    return kernel_accept(
        torch.from_numpy(x), torch.from_numpy(x0), tk.device_params("cpu"),
        torch.tensor(temp), torch.tensor(pdf_norm),
        torch.ones(len(x), dtype=torch.bool), stream=stream, lin=lin,
        apply_iw=True, family=tk.family), stream


def _assert_values_equal(got, ref):
    """-inf / NaN masks exactly equal, finite values within relative 1e-5
    (an absolute floor of 1e-5 for values near 0, where the terms cancel)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("case", IDS)
def test_logdensity_matches_jax_device_fn(case, edge):
    jk, tk = _kernels(dict(CASES)[case])
    x, x0 = _rows(seed=IDS.index(case), edge=edge)
    ref = _jax_values(jk, x, x0)
    (v, _a, _lw), _s = _port_values(tk, x, x0)
    _assert_values_equal(v.numpy(), ref)
    if not edge and case != "binomial-p1":  # p = 1: finite only at k = n
        assert np.isfinite(ref).sum() > len(ref) // 2


@pytest.mark.parametrize("case", IDS)
def test_accept_and_weights_follow_jax_rule(case):
    """The accept test and log weights: JAX's acceptor formula
    (``StochasticAcceptor.device_fn``) applied to the port's kernel values
    (held to JAX's above) and its Philox uniforms."""
    jk, tk = _kernels(dict(CASES)[case])
    x, x0 = _rows(seed=10 + IDS.index(case))
    (v, _a, _lw), _s = _port_values(tk, x, x0)
    lin = tk.ret_scale == LIN
    v = v.numpy()
    logv = np.log(np.maximum(v, np.float32(1e-30))) if lin else v
    pdf_norm = np.float32(np.nanmax(np.where(np.isfinite(logv), logv,
                                             -np.inf)) - 5.0)
    temp = np.float32(3.0)
    (_v, acc, lw), stream = _port_values(tk, x, x0, float(temp),
                                         float(pdf_norm))
    ratio = (logv - pdf_norm) / temp
    logu = np.log(accept_uniforms(stream, len(x)).numpy())
    clear = np.isnan(ratio) | (np.abs(logu - ratio)
                               > 1e-4 * (1 + np.abs(ratio)))
    np.testing.assert_array_equal(acc.numpy()[clear],
                                  (logu < ratio)[clear])
    want = np.where(ratio > 0, ratio, np.float32(0.0))
    fin = np.isfinite(ratio)
    np.testing.assert_allclose(lw.numpy()[fin], want[fin], rtol=1e-6,
                               atol=1e-6)
    assert acc.any() and not acc.all()


@pytest.mark.parametrize("case", IDS)
def test_pdf_max_host_call_and_params_equal(case):
    jk, tk = _kernels(dict(CASES)[case])
    if jk.pdf_max is None:
        assert tk.pdf_max is None
    else:
        assert tk.pdf_max == pytest.approx(jk.pdf_max, rel=1e-12)
    x, x0 = _rows(seed=20)
    for row in (x[0], x[7], x[10]):
        a, b = jk(row.astype(np.float64), x0), tk(row.astype(np.float64),
                                                  x0)
        assert (a == b == -np.inf) or a == pytest.approx(b, rel=1e-12)
    par = tk.device_params("cpu").numpy()
    jpar = jk.device_params()
    if case.startswith("normal"):
        prec, logdet = (np.asarray(p) for p in jpar)
        np.testing.assert_array_equal(par[:S * S], prec.ravel())
        assert par[S * S] == logdet
        assert par[S * S + 1] == np.float32(S * np.log(2 * np.pi))
    elif not case.startswith("poisson"):
        np.testing.assert_array_equal(
            par, np.broadcast_to(np.asarray(jpar, np.float32), (S,)))


# ------------------------------------------------------------ the bounds
BOUNDED = ["independent_normal", "laplace", "binomial", "poisson"]


def _imap(seed=0, n_seg=10):
    """A 10-segment emission map over the S columns, in shuffled order."""
    perm = np.random.default_rng(seed).permutation(S)
    return perm.reshape(n_seg, S // n_seg).astype(np.int32)


@pytest.mark.parametrize("case", BOUNDED)
def test_bound_folds_the_jax_prefixes(case):
    """Each prefix's accumulator equals the JAX bound fold's within f32
    rounding; it never increases, stays at or above the final
    log-density, and ``exceeds`` decides alike away from the threshold."""
    jk, tk = _kernels(dict(CASES)[case])
    x, x0 = _rows(seed=30 + BOUNDED.index(case))
    x = x[np.isfinite(x).all(axis=1)]
    B = len(x)
    jb, tb = jk.device_bound_fn(jk.spec), tk.device_bound_fn()
    assert jb["upper"] and tb["upper"]
    imap = _imap()
    par = tk.device_params("cpu")
    x_t, x0_t = torch.from_numpy(x), torch.from_numpy(x0)
    jacc = jnp.broadcast_to(jb["init"](), (B,))
    tacc = tb["init"](B)
    full = _jax_values(jk, x, x0)
    rng = np.random.default_rng(1)
    prev = tacc.clone()
    for idx in imap:
        jacc = jax.vmap(lambda a, v: jb["step"](
            a, v, jnp.asarray(idx), jnp.asarray(x0), jk.device_params()))(
            jacc, jnp.asarray(x[:, idx]))
        tacc = tb["step"](tacc, x_t[:, idx], idx, x0_t, par)
        ref = np.asarray(jacc)
        _assert_values_equal(tacc.numpy(), ref)
        got = tacc.numpy()
        assert np.all((got <= prev.numpy()) | np.isneginf(prev.numpy()))
        prev = tacc.clone()
        thr = (ref + rng.normal(0.0, 2.0, B)).astype(np.float32)
        jex = np.asarray(jax.vmap(lambda a, t: jb["exceeds"](a, t, None))(
            jacc, jnp.asarray(thr)))
        tex = tb["exceeds"](tacc, torch.from_numpy(thr)).numpy()
        with np.errstate(invalid="ignore"):
            clear = np.abs(np.abs(ref - thr) - (1e-3 + 1e-4 * np.abs(ref))) \
                > 1e-4 * (1 + np.abs(ref))
        np.testing.assert_array_equal(tex[clear], jex[clear])
    fin = np.isfinite(full)
    assert np.all(got[fin] >= full[fin] - 1e-4 * (1 + np.abs(full[fin])))


def test_bound_fold_is_the_entry_sum_then_one_update():
    """The fold's order (noise.cuh): the segment's entries summed in
    emission order, then one update of the accumulator."""
    vals = torch.tensor([[1.0, 3.0], [2.0, -1.0]])
    x0, var = torch.tensor([0.0, 1.0]), torch.tensor([2.0, 4.0])
    acc = torch.tensor([-3.0, -3.0])
    got = noise_bound_fold("independent_normal", acc, vals, x0, var)
    want = acc - 0.5 * (vals - x0).pow(2).div(var).sum(-1)
    assert torch.equal(got, want)


def test_unbounded_kernels_have_no_bound_as_in_jax():
    for case in ("normal", "normal-lin", "binomial-lin", "poisson-lin",
                 "negbin", "negbin-mean"):
        jk, tk = _kernels(dict(CASES)[case])
        assert jk.device_bound_fn(jk.spec) is None
        assert tk.device_bound_fn() is None, case


def test_what_still_raises_and_the_normal_size_limit():
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.IndependentLaplaceKernel(scale=lambda par: [1.0])
    with pytest.raises(NotImplementedError, match="item 11"):
        pt.PoissonKernel(keys=["x"])
    with pytest.raises(ValueError, match="p must be"):
        pt.BinomialKernel(p=0.0)
    with pytest.raises(ValueError, match="parameterization"):
        pt.NegativeBinomialKernel(p=0.5, parameterization="shape")
    # the (S, S) precision, x0 and 128 diff columns fit in 227 KB
    assert MAX_NORMAL_S == 185
    k = pt.NormalKernel(cov=np.eye(3))
    with pytest.raises(ValueError, match="shape"):
        k.initialize(SumStatSpec({"x": np.zeros(4)}))
