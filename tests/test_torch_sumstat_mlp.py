"""MLP learned summary statistics (K23's MLP fit and transform): the port's
modules against the JAX package on the CPU.

The same numpy inputs and layers go through the JAX package's
``ops/fit.py`` (``_mlp_forward``, ``jax.grad`` of ``mlp_fit_steps``'s
loss, its Adam step, ``mlp_fit_steps``, ``keep_if_finite``), its host
``MLPPredictor`` and its ``PNormDistance(sumstat=...).device_fn``, and
through the port's plain versions (``mlp_forward``, ``mlp_loss_grad`` by
the chain rule, ``adam_update``, ``mlp_fit_steps``, K23's MLP fit and
accept wrappers on CPU tensors). The layers are carried across by
``convert.predictor_from_jax``. Adam turns an ulp of a gradient entry near
0 into a step of about lr, so fits are held on the gradient and the loss,
not on the parameters after many steps.
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
from pyabc_tpu.ops import fit as jfit  # noqa: E402
from pyabc_tpu.sumstat import device as jdevice  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.kernels.mlp_fit import (  # noqa: E402
    caps_reason, mlp_fit, mlp_gradient_plain)
from pyabc_tpu_torch.kernels.mlp_sumstat import (  # noqa: E402
    mlp_accept, transform_rows)
from pyabc_tpu_torch.models import sir as tsir  # noqa: E402
from pyabc_tpu_torch.ops import fit as tfit  # noqa: E402
from pyabc_tpu_torch.sumstat import device as tdevice  # noqa: E402

torch.set_num_threads(1)

#: the gradient: float32 sums over the rows in another order (the
#: acceptance criterion's rel 1e-4, abs floor 1e-6)
G_RTOL, G_ATOL = 1e-4, 1e-6
#: the forward and the distances: S-term dot products in another order
D_RTOL = 1e-5
#: a fit's loss after 20 Adam steps from the same layers
LOSS_RTOL = 1e-3
#: (S, hidden, C'): the small shapes of the port's tests
SHAPES = [(6, (8, 8), 1), (10, (16, 16), 2), (16, (8,), 2)]


def _f32(x):
    return torch.tensor(np.asarray(x, np.float32))


def _rows(S, C, n=300, seed=7):
    """Raw statistics with a nonlinear signal and columns of other
    scales, targets of it, weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, S)) * np.arange(1, S + 1) + 10.0
    y = np.tanh((x[:, :C] - 10.0) / 2.0) + 0.05 * rng.normal(size=(n, C))
    w = rng.random(n) + 0.1
    return x, y, w, rng


def _pair(S, hidden, C, seed=3):
    """A JAX MLPPredictor fitted for 30 steps and the port's copy of it
    (``convert.predictor_from_jax``): the same layers."""
    x, y, w, rng = _rows(S, C, seed=seed)
    jp = jpt.MLPPredictor(hidden=hidden, n_steps=30, seed=seed)
    jp.fit(x, y, w)
    return jp, convert.predictor_from_jax(jp), rng


def _layers_np(layers):
    return [{k: np.asarray(layer[k]) for k in ("w", "b")} for layer in layers]


# ------------------------------------------------------ forward, gradient
@pytest.mark.parametrize("S,hidden,C", SHAPES)
def test_mlp_forward_matches_jax(S, hidden, C):
    jp, tp, rng = _pair(S, hidden, C)
    xs = rng.normal(size=(64, S)).astype(np.float32)
    ref = np.asarray(jfit._mlp_forward(jp.device_params()["layers"],
                                       jnp.asarray(xs)))
    got = tfit.mlp_forward(tp.device_params("cpu")["layers"], _f32(xs))
    np.testing.assert_allclose(got.numpy(), ref, rtol=D_RTOL, atol=1e-6)


def _loss_rows(S, C, seed=5):
    """Standardized, masked rows and normalized weights, as
    ``mlp_fit_steps`` forms them (float64 numpy)."""
    x, y, w, _rng = _rows(S, C, seed=seed)
    mask = np.arange(len(x)) < 211
    xs = (x - x[mask].mean(0)) / x[mask].std(0) * mask[:, None]
    ys = (y - y[mask].mean(0)) / y[mask].std(0) * mask[:, None]
    wts = w * mask
    wts = wts / (wts.sum() / mask.sum())
    return xs, ys, wts, int(mask.sum())


@pytest.mark.parametrize("S,hidden,C", SHAPES)
def test_mlp_loss_grad_matches_jax_grad(S, hidden, C):
    jp, tp, _rng = _pair(S, hidden, C)
    xs, ys, wts, n = _loss_rows(S, C)
    jx, jy, jw = (jnp.asarray(a, jnp.float32) for a in (xs, ys, wts))

    def loss_fn(p):
        pred = jfit._mlp_forward(p, jx)
        return jnp.sum(jw[:, None] * (pred - jy) ** 2) / (n * C)

    jloss, jgrad = jax.value_and_grad(loss_fn)(jp.device_params()["layers"])
    tloss, tgrad = tfit.mlp_loss_grad(tp.device_params("cpu")["layers"],
                                      _f32(xs), _f32(ys), _f32(wts), n)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=G_RTOL)
    for jl, tl in zip(_layers_np(jgrad), tgrad):
        for k in ("w", "b"):
            np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=G_RTOL,
                                       atol=G_ATOL, err_msg=k)


def test_mlp_loss_grad_matches_autograd():
    """The chain rule written out against torch's autograd (a second
    check; the port's path has no autograd)."""
    _jp, tp, _rng = _pair(10, (16, 16), 2)
    xs, ys, wts, n = _loss_rows(10, 2)
    layers = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
              for layer in tp.device_params("cpu")["layers"]]
    pred = tfit.mlp_forward(layers, _f32(xs))
    loss = (_f32(wts)[:, None] * (pred - _f32(ys)) ** 2).sum() / (n * 2)
    loss.backward()
    _l, grads = tfit.mlp_loss_grad(
        [{k: v.detach() for k, v in layer.items()} for layer in layers],
        _f32(xs), _f32(ys), _f32(wts), n)
    for layer, g in zip(layers, grads):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), layer[k].grad.numpy(),
                                       rtol=G_RTOL, atol=G_ATOL)


# ------------------------------------------------------------------ Adam
@pytest.mark.parametrize("t", [1, 7, 100])
def test_adam_update_matches_jax_step(t):
    """One step of the JAX package's inline Adam (``mlp_fit_steps``'s
    ``step``, written out on the same numbers) against ``adam_update``."""
    rng = np.random.default_rng(t)
    p, g = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(2))
    g[0, 0] = 0.0
    m = (rng.normal(size=(5, 3)) * 0.1 * (t > 1)).astype(np.float32)
    v = (rng.random((5, 3)) * 0.01 * (t > 1)).astype(np.float32)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 1e-3
    jm = b1 * jnp.asarray(m) + (1 - b1) * jnp.asarray(g)
    jv = b2 * jnp.asarray(v) + (1 - b2) * jnp.asarray(g) * jnp.asarray(g)
    tt = jnp.float32(t)
    jp_ = jnp.asarray(p) - lr * (jm / (1.0 - b1 ** tt)) / (
        jnp.sqrt(jv / (1.0 - b2 ** tt)) + eps)
    tp_, tm, tv = tfit.adam_update(_f32(p), _f32(m), _f32(v), _f32(g), t, lr)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp_), rtol=1e-6,
                               atol=1e-9)


# ------------------------------------------------------------ the fit
def _fit_inputs(S, C, n_keep=211, seed=11):
    x, y, w, _rng = _rows(S, C, seed=seed)
    mask = np.arange(len(x)) < n_keep
    return x, y, w, mask


@pytest.mark.parametrize("n_steps", [1, 5, 20])
@pytest.mark.parametrize("S,hidden,C", SHAPES[:2])
def test_mlp_fit_steps_matches_jax(S, hidden, C, n_steps):
    """From the same carried layers: the standardization within 1e-5, the
    parameters after one step within lr of each other's (Adam's first step
    is lr times the gradient's sign), the loss after 20 steps within
    rel 1e-3."""
    jp, tp, _rng = _pair(S, hidden, C)
    x, y, w, mask = _fit_inputs(S, C)
    ref = jfit.mlp_fit_steps(
        jp.device_params(), jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32), jnp.asarray(w, jnp.float32),
        jnp.asarray(mask), lr=1e-3, n_steps=n_steps)
    got = tfit.mlp_fit_steps(tp.device_params("cpu"), _f32(x), _f32(y),
                             _f32(w), torch.as_tensor(mask), lr=1e-3,
                             n_steps=n_steps)
    for k in tfit.MLP_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    rows = tfit.mlp_fit_rows(got, _f32(x), _f32(y), _f32(w),
                             torch.as_tensor(mask))[:4]
    jlayers = [{k: _f32(v) for k, v in layer.items()}
               for layer in _layers_np(ref["layers"])]
    loss_t = float(tfit.mlp_loss_grad(got["layers"], *rows)[0])
    loss_j = float(tfit.mlp_loss_grad(jlayers, *rows)[0])
    loss_0 = float(tfit.mlp_loss_grad(tp.device_params("cpu")["layers"],
                                      *rows)[0])
    assert loss_t < loss_0
    np.testing.assert_allclose(loss_t, loss_j, rtol=LOSS_RTOL)
    if n_steps == 1:
        for jl, tl in zip(_layers_np(ref["layers"]), got["layers"]):
            for k in ("w", "b"):
                np.testing.assert_allclose(tl[k].numpy(), jl[k], rtol=0,
                                           atol=2e-3)


def _old(S, hidden, C, seed=0):
    return tpt.MLPPredictor(seed=seed).init_params((S, *hidden, C))


def _counters(n_acc, n_target):
    c = torch.zeros(5, dtype=torch.int32)
    c[0], c[4] = n_acc, n_target
    return c


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tfit.param_leaves(a),
                                                 tfit.param_leaves(b)))


@pytest.mark.parametrize("poison", ["nan row", "inf weight"])
def test_finite_guard_keeps_old(poison):
    """A fit with a non-finite leaf keeps the old parameters (``ok`` 0),
    as the JAX guard over every leaf."""
    x, y, w, _mask = _fit_inputs(6, 2)
    if poison == "nan row":
        x[5, 2] = np.nan
    else:
        w[9] = np.inf
    old = _old(6, (8, 8), 2)
    params, flags = mlp_fit(_f32(x), _f32(y), _f32(w), _counters(300, 300),
                            old, lr=1e-3, n_steps=3, need=8)
    assert flags.tolist() == [0, 1]
    assert _leaves_equal(params, old)
    jold = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
                       for layer in old["layers"]],
            **{k: jnp.asarray(old[k].numpy()) for k in tfit.MLP_KEYS}}
    jnew = jax.tree.map(lambda a: a, jold)
    jnew["ysd"] = jnp.full_like(jnew["ysd"], jnp.inf)
    _, ok = jfit.keep_if_finite(jnew, jold)
    tnew = dict(old, ysd=torch.full_like(old["ysd"], math.inf))
    kept, tok = tfit.keep_if_finite(tnew, old)
    assert bool(tok) is bool(ok) is False
    assert _leaves_equal(kept, old)


@pytest.mark.parametrize("n_acc,n_target,need,fits", [
    (250, 211, 211, True),   # complete generation, at need
    (250, 211, 212, False),  # complete, below need
    (150, 211, 8, False),    # incomplete: the old parameters
])
def test_mlp_fit_decision(n_acc, n_target, need, fits):
    """K23's MLP fit decides from the counters as the linear fit does:
    n_keep = min(n_acc, n_target) rows, a complete generation, need."""
    x, y, w, _mask = _fit_inputs(6, 2)
    x, y, w = _f32(x), _f32(y), _f32(w)
    old = _old(6, (8, 8), 2)
    params, flags = mlp_fit(x, y, w, _counters(n_acc, n_target), old,
                            lr=1e-3, n_steps=5, need=need)
    assert flags.tolist() == [1, int(fits)]
    if fits:
        ref = tfit.mlp_fit_steps(old, x, y, w, torch.arange(300) < 211,
                                 lr=1e-3, n_steps=5)
        assert _leaves_equal(params, ref)
    else:
        assert _leaves_equal(params, old)
    grad = mlp_fit.gradient(x, y, w, _counters(n_acc, n_target), old,
                            need=need)
    assert grad.shape == (tfit.mlp_layout((6, 8, 8, 2))[1],)
    assert torch.isfinite(grad).all()


def test_gradient_entry_is_the_chain_rule():
    """``mlp_fit.gradient`` (the card check's entry) is mlp_loss_grad's
    gradient on the fit's rows, packed in the kernels' order."""
    x, y, w, mask = _fit_inputs(10, 2)
    old = _old(10, (16, 16), 2, seed=4)
    g = mlp_gradient_plain(_f32(x), _f32(y), _f32(w), _counters(211, 211),
                           old, need=8)
    rows = tfit.mlp_fit_rows(old, _f32(x), _f32(y), _f32(w),
                             torch.as_tensor(mask))[:4]
    ref = tfit.mlp_loss_grad(old["layers"], *rows)[1]
    back = tfit.unpack_layers(g, (10, 16, 16, 2))
    for a, b in zip(back, ref):
        for k in ("w", "b"):
            assert torch.equal(a[k], b[k])


# ------------------------------------------------- the transform, accept
@pytest.mark.parametrize("p", [1.0, 2.0, math.inf])
def test_mlp_accept_matches_jax_device_fn(p):
    jp, tp, rng = _pair(10, (16, 16), 2)
    S, B = 10, 128
    jd = jpt.PNormDistance(p=p, sumstat=jpt.PredictorSumstat(jp))
    jd.initialize(0, x_0={"s": np.zeros(S)})
    jd.sumstat._out_dim = 2
    x0 = (rng.normal(size=S) * 2 + 10).astype(np.float32)
    ss = (x0 + rng.normal(size=(B, S)) * 3).astype(np.float32)
    params = jd.device_params(1)
    fn = jd.device_fn(jd.spec)
    ref = np.asarray(jax.vmap(lambda r: fn(r, jnp.asarray(x0), params))(
        jnp.asarray(ss)))
    tparams = tp.device_params("cpu")
    w = torch.ones(2)
    eps = torch.tensor(float(np.median(ref)))
    valid = torch.ones(B, dtype=torch.bool)
    valid[7] = False
    logpri, logq = torch.randn(B) - 3.0, torch.randn(B) - 2.0
    d, acc, lw = mlp_accept(_f32(ss), _f32(x0), tparams, w, eps, valid, p=p,
                            logpri=logpri, logq=logq)
    np.testing.assert_allclose(d.numpy(), ref, rtol=D_RTOL, atol=1e-6)
    assert torch.equal(acc, valid & (d <= eps))
    assert lw[7] == -math.inf
    assert torch.equal(lw[valid], (logpri - logq)[valid])
    assert torch.equal(mlp_accept.values(_f32(ss), _f32(x0), tparams, w,
                                         p=p), d)
    np.testing.assert_allclose(
        transform_rows(_f32(ss), tparams).numpy(),
        np.asarray(jax.vmap(lambda r: jp.device_predict(
            r, params["ss"]))(jnp.asarray(ss))), rtol=D_RTOL, atol=1e-5)


# ---------------------------------------------------- the host predictor
def _predictor_rows(seed=0):
    """tests/test_sumstat.py::TestPredictors's data."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 6))
    W = rng.normal(size=(6, 2))
    return x, x @ W + 0.05 * rng.normal(size=(400, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_mlp_predictor_recovers_signal(seed):
    """The JAX suite's rule (tests/test_sumstat.py:23-40): the residual on
    held-out rows under 0.25 of the mean predictor's, in both packages."""
    x, y = _predictor_rows(seed)
    for pkg in (jpt, tpt):
        p = pkg.MLPPredictor(n_steps=300)
        if pkg is tpt:
            p.device = "cpu"
        p.fit(x[:300], y[:300])
        assert p.fitted
        resid = np.mean((p.predict(x[300:]) - y[300:]) ** 2)
        base = np.mean((y[300:] - y[:300].mean(0)) ** 2)
        assert resid < 0.25 * base, pkg.__name__


def test_mlp_predictor_device_predict_matches_host():
    """tests/test_sumstat.py:42-52 on the port: the device transform of a
    row within 1e-3 of the host predict; the seed's init repeats."""
    x, y = _predictor_rows()
    p = tpt.MLPPredictor(n_steps=100)
    p.device = "cpu"
    p.fit(x, y)
    params = p.device_params("cpu")
    got = p.device_predict(_f32(x[0]), params)
    np.testing.assert_allclose(got.numpy(), p.predict(x[0]), rtol=1e-3,
                               atol=1e-3)
    q = tpt.MLPPredictor(n_steps=100)
    q.device = "cpu"
    q.fit(x, y)
    assert all(np.array_equal(a[k], b[k]) for a, b in zip(p._params,
                                                           q._params)
               for k in ("w", "b"))
    assert tfit.pack_layers(params["layers"]) is \
        params["layers"][0]["w"]._base


def test_predictor_from_jax_carries_an_mlp():
    """A fitted JAX MLPPredictor carried across predicts as the JAX one
    within 1e-5; its sumstat too."""
    jp, tp, rng = _pair(9, (16, 16), 3, seed=4)
    assert (tp.hidden, tp.n_steps, tp.lr, tp.seed) == (
        jp.hidden, jp.n_steps, jp.lr, jp.seed)
    x = rng.normal(size=(50, 9)) * 4 + 10.0
    np.testing.assert_allclose(tp.predict(x), jp.predict(x), rtol=1e-5,
                               atol=1e-5)
    js = jpt.PredictorSumstat(jp, min_samples=40)
    js._out_dim, js._last_fit_t = 3, 4
    ts = convert.sumstat_from_jax(js)
    assert (ts._out_dim, ts._last_fit_t, ts.min_samples) == (3, 4, 40)
    assert ts.predictor.fitted and ts.predictor.hidden == (16, 16)
    unfitted = convert.predictor_from_jax(jpt.MLPPredictor(hidden=(4,)))
    assert not unfitted.fitted and unfitted.hidden == (4,)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_mirror_round_trip_bit_identical(pkg):
    """mirror_fitted_params stores an MLP's fetched float32 layers and
    standardization; the predictor's device parameters give them back bit
    for bit."""
    rng = np.random.default_rng(3)
    sizes = (6, 8, 2)
    host = {"layers": [{"w": rng.normal(size=(a, b)).astype(np.float32),
                        "b": rng.normal(size=b).astype(np.float32)}
                       for a, b in zip(sizes[:-1], sizes[1:])],
            "mu": rng.normal(size=6).astype(np.float32),
            "sd": rng.random(6).astype(np.float32) + 0.5,
            "ymu": rng.normal(size=2).astype(np.float32),
            "ysd": rng.random(2).astype(np.float32) + 0.5}
    mod = jpt if pkg == "jax" else tpt
    dist = mod.PNormDistance(p=2, sumstat=mod.PredictorSumstat(
        mod.MLPPredictor()))
    (jdevice if pkg == "jax" else tdevice).mirror_fitted_params(dist, host,
                                                                5)
    pred = dist.sumstat.predictor
    back = pred.device_params() if pkg == "jax" else pred.device_params(
        "cpu")
    assert dist.sumstat._last_fit_t == 5 and dist.sumstat._out_dim == 2
    for a, b in zip(back["layers"], host["layers"]):
        for k in ("w", "b"):
            assert np.array_equal(np.asarray(a[k]), b[k])
    for k in tfit.MLP_KEYS:
        assert np.array_equal(np.asarray(back[k]), host[k])


# ------------------------------------------------------- layout and caps
def test_packed_layout():
    """The kernels' packed order: each layer's w row-major, then its b;
    unpack gives views that pack back to the buffer itself."""
    sizes = (5, 4, 3, 2)
    spots, P = tfit.mlp_layout(sizes)
    assert P == 5 * 4 + 4 + 4 * 3 + 3 + 3 * 2 + 2
    assert [s[:2] for s in spots] == [(0, 20), (24, 36), (39, 45)]
    flat = torch.arange(P, dtype=torch.float32)
    layers = tfit.unpack_layers(flat, sizes)
    assert tfit.pack_layers(layers) is flat
    copy = [{k: v.clone() for k, v in layer.items()} for layer in layers]
    packed = tfit.pack_layers(copy)
    assert packed is not flat and torch.equal(packed, flat)


@pytest.mark.parametrize("sizes,fragment", [
    ((128, 64, 64, 2), None),
    ((160, 128, 128, 8), None),
    ((128, 256, 2), "hidden widths"),
    ((128, 16, 16, 16, 16, 2), "hidden layers"),
    ((200, 64, 2), "raw statistics"),
    ((160, 128, 128, 128, 8), "bytes of a block"),
])
def test_caps(sizes, fragment):
    reason = caps_reason(sizes)
    assert (reason is None) == (fragment is None)
    if fragment is not None:
        assert fragment in reason


def test_mlp_beyond_the_caps_refused_before_launch():
    """An MLP the kernels cannot hold raises ``not_ported`` at the run's
    start, before generation 0."""
    shape = dict(n_patches=2, n_obs=8)
    abc = tpt.ABCSMC(tsir.make_network_sir_model(**shape),
                     tsir.network_sir_prior(),
                     tpt.PNormDistance(p=2, sumstat=tpt.PredictorSumstat(
                         tpt.MLPPredictor(hidden=(256,)))),
                     population_size=64, device="cpu")
    abc.new("sqlite://", tsir.observed_network_sir(**shape))
    with pytest.raises(NotImplementedError, match="item 14"):
        abc.run(max_nr_populations=2)
    assert abc.history.max_t < 0
