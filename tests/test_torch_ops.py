"""Port parity: the per-generation device ops (K7 stats, K10 fetch
packing, K11 health word) against the JAX package, on the same numpy
inputs."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.ops import health as jhealth  # noqa: E402
from pyabc_tpu.ops import pack as jpack  # noqa: E402
from pyabc_tpu.ops import stats as jstats  # noqa: E402
from pyabc_tpu_torch.ops import health, pack, stats  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("weighted", [False, True])
def test_weighted_quantile_matches_jax(alpha, weighted):
    rng = np.random.default_rng(int(alpha * 10) + weighted)
    pts = rng.exponential(size=200).astype(np.float32)
    pts[150:] = np.inf  # masked reservoir slots
    w = (rng.random(200) if weighted else np.ones(200)).astype(np.float32)
    w[150:] = 0.0
    ref = float(jstats.weighted_quantile(jnp.asarray(pts), jnp.asarray(w),
                                         alpha))
    got = float(stats.weighted_quantile(torch.from_numpy(pts),
                                        torch.from_numpy(w), alpha))
    # the same sorted point is chosen unless a cumsum lands within float32
    # rounding of alpha; these inputs keep clear of that
    assert got == ref


@pytest.mark.parametrize("case", ["plain", "masked", "all_inf"])
def test_normalize_log_weights_matches_jax(case):
    rng = np.random.default_rng(0)
    lw = rng.normal(-40, 5, size=64).astype(np.float32)
    mask = np.ones(64, bool)
    if case == "masked":
        mask[40:] = False
        lw[3] = -np.inf
    if case == "all_inf":
        lw[:] = -np.inf
    ref = np.asarray(jstats.normalize_log_weights(jnp.asarray(lw),
                                                  jnp.asarray(mask)))
    got = stats.normalize_log_weights(torch.from_numpy(lw),
                                      torch.from_numpy(mask)).numpy()
    # exp and a 64-term sum in float32: rel 1e-6
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("name", ["float32", "float16", "bfloat16"])
def test_pack_rows_matches_jax(name):
    rng = np.random.default_rng(3)
    G, n_cap, n_keep, d = 3, 40, 33, 4
    theta = rng.normal(0, 3, size=(G, n_cap, d)).astype(np.float32)
    dist = rng.exponential(0.6, size=(G, n_cap)).astype(np.float32)
    dist[0, 0] = 0.6001  # rounds to 0.6001 > x at f16 under nearest
    lw = rng.normal(0, 2, size=(G, n_cap)).astype(np.float32)
    ref = jpack.pack_outs(
        {"theta": jnp.asarray(theta), "distance": jnp.asarray(dist),
         "log_weight": jnp.asarray(lw), "m": jnp.zeros((G, n_cap)),
         "slot": jnp.zeros((G, n_cap)), "sumstats": jnp.zeros((G, n_cap, 1)),
         "eps_used": jnp.zeros(G)},
        n_keep=n_keep, dtype=jpack.fetch_dtype_of(name), keep_m=False,
        ss_gens=())
    got = pack.pack_rows(torch.from_numpy(theta), torch.from_numpy(dist),
                         torch.from_numpy(lw), n_keep=n_keep,
                         dtype=pack.fetch_dtype_of(name))
    ref_rows = np.asarray(ref["rows"]).astype(np.float32)
    got_rows = got.float().numpy()
    # the same IEEE narrowing casts: bit-identical values
    np.testing.assert_array_equal(got_rows, ref_rows)
    # the distance column never rounds above the true distance
    assert np.all(got_rows[..., d] <= dist[:, :n_keep])
    t, dd, w = pack.unpack_rows(got_rows, d)
    assert t.shape == (G, n_keep, d) and dd.dtype == np.float64


def _health_inputs(kind):
    rng = np.random.default_rng(0)
    n_cap, d = 32, 2
    theta = rng.normal(size=(n_cap, d)).astype(np.float32)
    k_mask = np.arange(n_cap) < 20
    w = np.where(k_mask, 1.0 / 20, 0.0).astype(np.float32)
    d_new = rng.exponential(size=n_cap).astype(np.float32)
    params = {"thetas": theta, "weights": w,
              "chol": np.eye(d, dtype=np.float32),
              "prec": np.eye(d, dtype=np.float32)}
    eps_prev, eps_g, eps_next = 1.0, 0.5, 0.4
    if kind == "nan_theta":
        theta[3, 1] = np.nan
    elif kind == "zero_weight":
        w[:] = 0.0
    elif kind == "psd":
        params["chol"] = np.full((d, d), np.nan, np.float32)
    elif kind == "stall":
        eps_prev = eps_g
    return dict(theta=theta, k_mask=k_mask, w_norm=w, d_new=d_new,
                params=params, eps_prev=eps_prev, eps_g=eps_g,
                eps_next=eps_next)


@pytest.mark.parametrize("kind", ["ok", "nan_theta", "zero_weight", "psd",
                                  "stall"])
def test_generation_health_matches_jax(kind):
    x = _health_inputs(kind)
    cfg = dict(ess_floor=0.5, acc_floor=0.3, stall_window=1,
               stall_rtol=1e-3)
    jp = {k: jnp.asarray(v) for k, v in x["params"].items()}
    word, ess, _ep, stall = jhealth.generation_health(
        res={"theta": jnp.asarray(x["theta"])},
        k_mask=jnp.asarray(x["k_mask"]), w_norm=jnp.asarray(x["w_norm"]),
        d_new=jnp.asarray(x["d_new"]), n_acc=jnp.int32(20), n_target=20,
        acc_rate=jnp.float32(0.25), trans_params=(jp,), trans_next=(jp,),
        fitted=jnp.asarray([True]), fitted_next=jnp.asarray([True]),
        eps_g=jnp.float32(x["eps_g"]), eps_next=jnp.float32(x["eps_next"]),
        eps_prev=jnp.float32(x["eps_prev"]), stall_count=jnp.int32(0),
        **cfg)
    tp = {k: torch.from_numpy(v) for k, v in x["params"].items()}
    t = torch.from_numpy
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    tword, tess, _tep, tstall = health.generation_health(
        theta=t(x["theta"]), k_mask=t(x["k_mask"]), w_norm=t(x["w_norm"]),
        d_new=t(x["d_new"]), n_acc=torch.tensor(20), n_target=20,
        acc_rate=f(0.25), trans_params=tp, trans_next=tp,
        fitted=torch.tensor(True), fitted_next=torch.tensor(True),
        eps_g=f(x["eps_g"]), eps_next=f(x["eps_next"]),
        eps_prev=f(x["eps_prev"]),
        stall_count=torch.tensor(0, dtype=torch.int32),
        **cfg)
    assert int(tword) == int(word), (health.decode(int(tword)),
                                     health.decode(int(word)))
    assert int(tstall) == int(stall)
    if np.isinf(float(ess)):
        # zero total weight: both clamp sum(w^2) at 1e-38, a float32
        # subnormal that XLA flushes to zero (1/0 = inf) and PyTorch keeps
        assert float(tess) >= 1e37
    else:
        np.testing.assert_allclose(float(tess), float(ess), rtol=1e-6)
    assert health.BIT_NAMES == jhealth.BIT_NAMES


def _edge_quantile_inputs(case):
    rng = np.random.default_rng(7)
    n = 64
    pts = rng.exponential(size=n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    mask = np.ones(n, bool)
    if case == "all_masked":
        mask[:] = False
    elif case == "one_valid":
        mask[:] = False
        mask[5] = True
    elif case == "ties":
        pts = (np.round(pts * 2) / 2).astype(np.float32)
    elif case == "odd_count":
        mask[33:] = False
    return np.where(mask, pts, np.inf).astype(np.float32), w, mask


@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", ["all_masked", "one_valid", "ties",
                                  "odd_count"])
def test_weighted_quantile_edge_cases_match_jax(case, weighted, alpha):
    pts, w, mask = _edge_quantile_inputs(case)
    wts = np.where(mask, w if weighted else 1.0, 0.0).astype(np.float32)
    ref = float(jstats.weighted_quantile(jnp.asarray(pts), jnp.asarray(wts),
                                         alpha))
    got = float(stats.weighted_quantile(torch.from_numpy(pts),
                                        torch.from_numpy(wts), alpha))
    # the same stable sort and left search: equal (all masked: +inf)
    assert got == ref


@pytest.mark.parametrize("case", ["all_masked", "one_valid", "ties"])
def test_normalize_log_weights_edge_cases_match_jax(case):
    _pts, w, mask = _edge_quantile_inputs(case)
    lw = np.log(w).astype(np.float32)
    ref = np.asarray(jstats.normalize_log_weights(jnp.asarray(lw),
                                                  jnp.asarray(mask)))
    got = stats.normalize_log_weights(torch.from_numpy(lw),
                                      torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
    assert got.sum() == pytest.approx(float(mask.any()), rel=1e-6)


#: float32 values at the edges of the narrowing casts: negative, zero,
#: subnormal in float16, above float16's range, NaN and infinities
EDGE_VALUES = np.array([-0.6001, -0.0, 0.0, 1e-7, 3e-5, 0.6001, 65519.0,
                        65520.0, 7e4, 3.4e38, np.nan, np.inf, -np.inf],
                       np.float32)


@pytest.mark.parametrize("name", ["float32", "float16", "bfloat16"])
def test_pack_rows_of_separate_generations_match_jax(name):
    """K10 reads each generation's reservoir in place: a list of G tensors,
    with the casts' edge values in every column."""
    rng = np.random.default_rng(11)
    G, n_cap, n_keep, d, S = 3, 24, 17, 2, 5
    theta = rng.normal(0, 3, size=(G, n_cap, d)).astype(np.float32)
    dist = rng.exponential(0.6, size=(G, n_cap)).astype(np.float32)
    lw = rng.normal(0, 2, size=(G, n_cap)).astype(np.float32)
    ss = rng.normal(0, 1e4, size=(G, n_cap, S)).astype(np.float32)
    k = len(EDGE_VALUES)
    dist[1, :k] = theta[2, :k, 0] = lw[0, :k] = EDGE_VALUES
    ss[2, :k, 3] = EDGE_VALUES
    dtype = jpack.fetch_dtype_of(name)
    ref = jpack.pack_outs(
        {"theta": jnp.asarray(theta), "distance": jnp.asarray(dist),
         "log_weight": jnp.asarray(lw), "sumstats": jnp.asarray(ss),
         "eps_used": jnp.zeros(G)},
        n_keep=n_keep, dtype=dtype, keep_m=False, ss_gens=(0, 2))
    tdtype = pack.fetch_dtype_of(name)
    got = pack.pack_rows([torch.from_numpy(theta[g]) for g in range(G)],
                         [torch.from_numpy(dist[g]) for g in range(G)],
                         [torch.from_numpy(lw[g]) for g in range(G)],
                         n_keep=n_keep, dtype=tdtype)
    got_ss = pack.pack_sumstats([torch.from_numpy(ss[g]) for g in (0, 2)],
                                n_keep=n_keep, dtype=tdtype)
    # the same IEEE narrowing casts: bit-identical values, NaN where NaN
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref["rows"]).astype(np.float32))
    for j, g in enumerate((0, 2)):
        np.testing.assert_array_equal(
            got_ss[j].float().numpy(),
            np.asarray(ref["__ss_rows__"][g]).astype(np.float32))
    # within float16's normal range the distance never rounds up (both
    # packages round up subnormals and overflow past the largest value)
    kept = dist[:, :n_keep]
    inside = (np.abs(kept) >= 1e-4) & (np.abs(kept) < 6e4)
    assert np.all(got[..., d].float().numpy()[inside] <= kept[inside])


def _health_edge_inputs(kind):
    x = _health_inputs("ok")
    cfg = dict(ess_floor=0.5, acc_floor=0.3, stall_window=2,
               stall_rtol=1e-3)
    n_acc, acc_rate, stall = 20, 0.25, 1
    fitted = fitted_next = True
    next_params = {k: v.copy() for k, v in x["params"].items()}
    if kind == "nan_weight":
        x["w_norm"][4] = np.nan
    elif kind == "nan_weight_masked":
        x["w_norm"][25] = np.nan  # outside the kept rows: no bit
        x["theta"][30, 0] = np.inf
        x["d_new"][29] = np.nan
    elif kind == "nan_distance":
        x["d_new"][7] = np.inf
    elif kind == "ess_floor":
        x["w_norm"][:20] = np.where(np.arange(20) == 0, 0.81, 0.01)
    elif kind == "acc_collapse":
        acc_rate = 0.1
    elif kind == "eps_nonfinite":
        x["eps_next"] = np.inf
    elif kind == "unfitted_nan":
        # never-fitted params are zeros by construction, never checked
        x["params"]["chol"][:] = np.nan
        fitted = False
    elif kind == "refit_zero_weights":
        next_params["weights"][:] = 0.0
    elif kind == "all_masked":
        x["k_mask"][:] = False
        x["w_norm"][:] = 0.0
        n_acc, fitted_next = 0, False
    elif kind == "stall_off":
        x["eps_prev"] = x["eps_g"]
        cfg["stall_window"] = 0
    elif kind == "stall_window":
        x["eps_prev"] = x["eps_g"] * (1 + 1e-4)
    elif kind == "fresh_eps_prev":
        x["eps_prev"] = np.inf
    return x, cfg, n_acc, acc_rate, stall, fitted, fitted_next, next_params


@pytest.mark.parametrize("kind", [
    "nan_weight", "nan_weight_masked", "nan_distance", "ess_floor",
    "acc_collapse", "eps_nonfinite", "unfitted_nan", "refit_zero_weights",
    "all_masked", "stall_off", "stall_window", "fresh_eps_prev"])
def test_generation_health_edges_match_jax(kind):
    """K11's every bit, its stall recursion and the masks against the JAX
    package (the port's wrapper on CPU tensors)."""
    (x, cfg, n_acc, acc_rate, stall, fitted, fitted_next,
     next_params) = _health_edge_inputs(kind)
    jp = {k: jnp.asarray(v) for k, v in x["params"].items()}
    jn = {k: jnp.asarray(v) for k, v in next_params.items()}
    word, ess, _ep, jstall = jhealth.generation_health(
        res={"theta": jnp.asarray(x["theta"])},
        k_mask=jnp.asarray(x["k_mask"]), w_norm=jnp.asarray(x["w_norm"]),
        d_new=jnp.asarray(x["d_new"]), n_acc=jnp.int32(n_acc), n_target=20,
        acc_rate=jnp.float32(acc_rate), trans_params=(jp,), trans_next=(jn,),
        fitted=jnp.asarray([fitted]), fitted_next=jnp.asarray([fitted_next]),
        eps_g=jnp.float32(x["eps_g"]), eps_next=jnp.float32(x["eps_next"]),
        eps_prev=jnp.float32(x["eps_prev"]), stall_count=jnp.int32(stall),
        **cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    tword, tess, tep, tstall = health.generation_health(
        theta=torch.from_numpy(x["theta"]),
        k_mask=torch.from_numpy(x["k_mask"]),
        w_norm=torch.from_numpy(x["w_norm"]),
        d_new=torch.from_numpy(x["d_new"]),
        n_acc=torch.tensor(n_acc, dtype=torch.int32), n_target=20,
        acc_rate=f(acc_rate),
        trans_params={k: torch.from_numpy(v)
                      for k, v in x["params"].items()},
        trans_next={k: torch.from_numpy(v) for k, v in next_params.items()},
        fitted=torch.tensor(fitted), fitted_next=torch.tensor(fitted_next),
        eps_g=f(x["eps_g"]), eps_next=f(x["eps_next"]),
        eps_prev=f(x["eps_prev"]),
        stall_count=torch.tensor(stall, dtype=torch.int32), **cfg)
    assert int(tword) == int(word), (health.decode(int(tword)),
                                     health.decode(int(word)))
    assert int(tstall) == int(jstall)
    assert float(tep) == float(x["eps_g"])
    if np.isnan(float(ess)):
        assert np.isnan(float(tess))
    elif np.isinf(float(ess)):
        # zero total weight: XLA flushes the 1e-38 clamp (a float32
        # subnormal) to zero, PyTorch keeps it
        assert float(tess) >= 1e37
    else:
        np.testing.assert_allclose(float(tess), float(ess), rtol=1e-6)
