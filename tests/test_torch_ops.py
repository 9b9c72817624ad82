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
