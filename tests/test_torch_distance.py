"""Port parity: K5 (p-norm distance, uniform accept, log-weight) and the
adaptive scale / weight refit (K9), on the same numpy inputs as the JAX
package's ``PNormDistance.device_fn`` composed with
``UniformAcceptor.device_fn`` and the ``_lane_transition`` weight sum."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.distance import scale as jscale  # noqa: E402
from pyabc_tpu_torch import AdaptivePNormDistance  # noqa: E402
from pyabc_tpu_torch.distance import scale as tscale  # noqa: E402
from pyabc_tpu_torch.kernels import pnorm_accept_weight  # noqa: E402
from pyabc_tpu_torch.kernels.scale_reduce import weight_update_plain  # noqa: E402,E501

torch.set_num_threads(1)

B, S = 96, 12


def _round(seed=0):
    rng = np.random.default_rng(seed)
    ss = rng.normal(0, 2, size=(B, S)).astype(np.float32)
    ss[5] = np.nan  # a blown-up lane
    x0 = rng.normal(0, 1, size=S).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=S).astype(np.float32)
    valid = rng.random(B) > 0.1
    logpri = rng.normal(-3, 1, size=B).astype(np.float32)
    logpri[~valid] = -np.inf
    logq = rng.normal(-2, 1, size=B).astype(np.float32)
    return ss, x0, w, valid, logpri, logq


def _jax_lane(p, ss, x0, w, eps, valid, logpri, logq, hist_min=None):
    spec = jpt.SumStatSpec({"s": np.zeros(S)})
    acc = jpt.UniformAcceptor(use_complete_history=hist_min is not None)
    fn = acc.device_fn(jpt.PNormDistance(p=p).device_fn(spec))
    acc_params = () if hist_min is None else jnp.float32(hist_min)

    def lane(x, v, lp, lq):
        d, a, log_acc_w = fn(None, x, jnp.asarray(x0), jnp.float32(eps),
                             jnp.asarray(w), acc_params)
        # _lane_transition: K = 1, model prior and model factor log 0
        log_w = 0.0 + lp + log_acc_w - 0.0 - lq
        return d, a & v, jnp.where(v, log_w, -jnp.inf)

    out = jax.vmap(lane)(jnp.asarray(ss), jnp.asarray(valid),
                         jnp.asarray(logpri), jnp.asarray(logq))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("p", [1.0, 2.0, np.inf])
@pytest.mark.parametrize("complete_history", [False, True])
def test_pnorm_accept_weight_matches_jax(p, complete_history):
    ss, x0, w, valid, logpri, logq = _round(int(p) if np.isfinite(p) else 9)
    d_all = _jax_lane(p, ss, x0, w, 1e9, valid, logpri, logq)[0]
    eps = float(np.nanmedian(d_all))
    hist = float(np.nanquantile(d_all, 0.4)) if complete_history else None
    ref_d, ref_a, ref_lw = _jax_lane(p, ss, x0, w, eps, valid, logpri, logq,
                                     hist)
    t = torch.from_numpy
    d, a, lw = pnorm_accept_weight(
        t(ss), t(x0), t(w), torch.tensor(eps, dtype=torch.float32),
        t(valid), p=p, logpri=t(logpri), logq=t(logq),
        hist_min=None if hist is None else torch.tensor(
            hist, dtype=torch.float32))
    d, a, lw = d.numpy(), a.numpy(), lw.numpy()
    # sums of S terms in another order (and sqrt vs pow(., 0.5)): rel 1e-5
    np.testing.assert_allclose(d, ref_d, rtol=1e-5, atol=0, equal_nan=True)
    # accept flags compared where |d - threshold| exceeds that rounding
    thr = min(eps, hist) if hist is not None else eps
    far = np.abs(ref_d - thr) > 1e-5 * thr
    np.testing.assert_array_equal(a[far], ref_a[far])
    # the log-weight is the same two float32 additions: exact
    np.testing.assert_array_equal(lw, ref_lw)
    assert not a[5] and not a[~valid].any()


def test_prior_round_log_weight_is_zero():
    ss, x0, w, valid, _, _ = _round(4)
    valid[:] = True
    t = torch.from_numpy
    d, a, lw = pnorm_accept_weight(t(ss), t(x0), t(w),
                                   torch.tensor(np.inf), t(valid), p=2.0)
    assert np.all(lw.numpy() == 0.0)
    # eps = +inf (calibration) accepts every finite distance
    np.testing.assert_array_equal(a.numpy(), np.isfinite(d.numpy()))


@pytest.mark.parametrize("name", sorted(jscale.SCALE_FUNCTIONS))
def test_device_scales_match_jax(name):
    rng = np.random.default_rng(1)
    samples = rng.normal(3, 2, size=(300, S)).astype(np.float32)
    valid = rng.random(300) > 0.2
    x0 = rng.normal(3, 1, size=S).astype(np.float32)
    ref = np.asarray(jscale._device_scale_impls()[name](
        jnp.asarray(samples), jnp.asarray(valid), jnp.asarray(x0)))
    got = tscale.DEVICE_SCALES[name](torch.from_numpy(samples),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(x0)).numpy()
    # masked float32 reductions in another order: rel 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_ratio,normalize", [(None, True), (5.0, True),
                                                 (None, False)])
def test_weight_update_matches_jax(max_ratio, normalize):
    scale = np.array([0.5, 2.0, 0.0, 10.0, 1e-3, 3.0], np.float32)
    jd = jpt.AdaptivePNormDistance(p=2, max_weight_ratio=max_ratio,
                                   normalize_weights=normalize)
    ref = np.asarray(jd.device_weight_update()(jnp.asarray(scale)))
    td = AdaptivePNormDistance(p=2, max_weight_ratio=max_ratio,
                               normalize_weights=normalize)
    got = weight_update_plain(torch.from_numpy(scale), td.max_weight_ratio,
                              td.normalize_weights).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_calibration_weights_match_host_fit():
    """The initial adaptive weights on one calibration sample: the JAX
    package's host fit (float64 numpy MAD) against the port's device
    twin (float32)."""
    rng = np.random.default_rng(5)
    sample = rng.lognormal(0, 1, size=(500, S)).astype(np.float32)
    obs = {"s": np.ones(S)}
    jd = jpt.AdaptivePNormDistance(p=2)
    jd.initialize(0, lambda: sample.astype(np.float64), obs)
    td = AdaptivePNormDistance(p=2)
    got = weight_update_plain(td.scale(
        torch.from_numpy(sample), torch.ones(500, dtype=torch.bool),
        torch.ones(S)), td.max_weight_ratio, td.normalize_weights).numpy()
    # float32 medians against float64 ones: rel 1e-5
    np.testing.assert_allclose(got, jd.weights[0], rtol=1e-5)
    with pytest.raises(NotImplementedError, match="item 16"):
        AdaptivePNormDistance(scale_function=lambda s, x0=None: s.std(0))


def _edge_ring(case):
    rng = np.random.default_rng(8)
    n, s = 64, 4
    samples = rng.normal(3, 2, size=(n, s)).astype(np.float32)
    samples[:, 0] = np.round(samples[:, 0])  # ties at the median
    valid = rng.random(n) > 0.3
    if case == "nan_row":
        samples[4, 1] = np.nan  # a blown-up lane in a valid row
        valid[4] = True
    elif case == "even":
        valid[:] = False
        valid[:20] = True
    elif case == "odd":
        valid[:] = False
        valid[:21] = True
    elif case == "one_valid":
        valid[:] = False
        valid[9] = True
    elif case == "none_valid":
        valid[:] = False
    x0 = rng.normal(3, 1, size=s).astype(np.float32)
    return samples, valid, x0


@pytest.mark.parametrize("case", ["nan_row", "even", "odd", "one_valid",
                                  "none_valid"])
@pytest.mark.parametrize("name", sorted(jscale.SCALE_FUNCTIONS))
def test_device_scale_edge_cases_match_jax(name, case):
    samples, valid, x0 = _edge_ring(case)
    ref = np.asarray(jscale._device_scale_impls()[name](
        jnp.asarray(samples), jnp.asarray(valid), jnp.asarray(x0)))
    got = tscale.DEVICE_SCALES[name](torch.from_numpy(samples),
                                     torch.from_numpy(valid),
                                     torch.from_numpy(x0)).numpy()
    if "median" in name:
        # nanquantile's linear method in the same float32 steps: equal,
        # NaN left out (an empty column gives NaN)
        np.testing.assert_array_equal(got, ref)
    else:
        # masked float32 sums in another order; NaN propagates: rel 1e-5
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)


@pytest.mark.parametrize("max_ratio", [None, 4.0])
def test_refit_matches_jax_record_reduce_and_recompute(max_ratio):
    """One K9 call (scale over the ring, weights, the reservoir's
    distances under them) against the JAX package's record reduce, weight
    update and p-norm on the same ring."""
    samples, valid, x0 = _edge_ring("nan_row")
    rows = np.random.default_rng(1).normal(3, 2, size=(32, 4)).astype(
        np.float32)
    spec = jpt.SumStatSpec({"s": np.zeros(4)})
    jd = jpt.AdaptivePNormDistance(p=2, max_weight_ratio=max_ratio)
    j_w = jd.device_weight_update()(jd.device_record_reduce(spec)(
        jnp.asarray(samples), jnp.asarray(valid), jnp.asarray(x0)))
    j_d = np.asarray(jax.vmap(jd.device_fn(spec), in_axes=(0, None, None))(
        jnp.asarray(rows), jnp.asarray(x0), j_w))
    td = AdaptivePNormDistance(p=2, max_weight_ratio=max_ratio)
    w, d = td.refit(torch.from_numpy(samples), torch.from_numpy(valid),
                    torch.from_numpy(x0), torch.from_numpy(rows))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6)
    np.testing.assert_allclose(d.numpy(), j_d, rtol=1e-5)
