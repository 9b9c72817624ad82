"""LocalTransition's kernels (K12-K15 and K2's local mode, their plain
PyTorch versions on the CPU) against the JAX package's
``LocalTransition`` and ``ops/select.py``.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in the port. Tolerances, with their reasons:

- covariances: 1e-4 relative to each row's largest entry (float32 sums of
  up to ~1000 neighbour products in another order; an off-diagonal entry
  near 0 has no meaningful elementwise relative error);
- selections (indices, counts, radius) and ``n_changed``: exactly equal,
  the distances fed to both being the same tile;
- factors: chols and logdets 1e-5 absolute at O(1) scales, precisions
  1e-4 relative to the row's largest entry (the port inverts through the
  Cholesky factor, the JAX package by LU);
- densities: 1e-4 absolute + 1e-5 relative (float32 sums in another
  order, the per-component constant folded in once).
"""
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.ops import select as jsel  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu.transition.local_transition import (  # noqa: E402
    LocalTransition as JLocal)
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.local_cov import (  # noqa: E402
    k_table_host, local_cov, topk_neighbors)
from pyabc_tpu_torch.kernels.local_factor import (  # noqa: E402
    factorize_plain, local_factor)
from pyabc_tpu_torch.kernels.local_logpdf import local_logpdf  # noqa: E402
from pyabc_tpu_torch.kernels.proposal_drift import (  # noqa: E402
    device_proposal_drift, proposal_drift)
from pyabc_tpu_torch.kernels.propose import (  # noqa: E402
    propose_local, unbounded_prior)
from pyabc_tpu_torch.ops import select as tsel  # noqa: E402
from pyabc_tpu_torch.transition import LocalTransition  # noqa: E402
from pyabc_tpu_torch.transition import (  # noqa: E402
    device_chol_guarded_batched)

torch.set_num_threads(2)


def _population(n, d, seed, n_empty=0, scale=1.0):
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    w = rng.random(n).astype(np.float32) + 0.1
    if n_empty:
        w[-n_empty:] = 0.0
    return X, w


def _row_close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    n = a.shape[0]
    scale = np.abs(b).reshape(n, -1).max(axis=1)
    err = np.abs(a - b).reshape(n, -1).max(axis=1)
    assert np.all(err <= rtol * scale), float((err / scale).max())


# (n_cap, d, dim, n_empty, keywords of device_fit)
FIELD_CASES = {
    "topk_dense": (256, 3, 3, 30, dict(k_cap=64, k_fraction=0.25)),
    "topk_tiled": (256, 3, 2, 17, dict(k_cap=64, k_fraction=0.25,
                                       block_rows=64)),
    "threshold_stride1": (512, 2, 2, 40, dict(k_cap=128, k_fraction=0.25,
                                              selection="threshold")),
    "threshold_stride4": (1024, 4, 4, 64,
                          dict(k_cap=256, k_fraction=0.25,
                               selection="threshold", bisect_stride=4)),
    "k_max": (256, 2, 2, 0, dict(k_cap=20, k_fraction=0.5, k_max=20)),
    "k_fixed": (128, 3, 3, 8, dict(k=12)),
    "below_dim_plus_one": (64, 3, 3, 62, dict(k_cap=16, k_fraction=0.25)),
}


@pytest.mark.parametrize("case", sorted(FIELD_CASES))
def test_cov_field_matches_jax(case):
    n, d, dim, n_empty, kw = FIELD_CASES[case]
    X, w = _population(n, d, seed=n + d, n_empty=n_empty)
    jcov, jX, jw, _vm, _o = JLocal._device_cov_field(
        jnp.asarray(X), jnp.asarray(w), dim=dim, scaling=1.3, **kw)
    field = local_cov(torch.tensor(X), torch.tensor(w),
                      **LocalTransition.field_config(n, dim, scaling=1.3,
                                                     **kw))
    _row_close(field["covs"].numpy(), jcov, 1e-4)
    np.testing.assert_array_equal(field["thetas"].numpy(), np.asarray(jX))
    np.testing.assert_allclose(field["weights"].numpy(), np.asarray(jw),
                               rtol=1e-6)
    np.testing.assert_allclose(field["cdf"].numpy(),
                               convert.ancestor_cdf(np.asarray(jw)),
                               rtol=1e-5, atol=1e-7)


def test_k_table_is_the_host_rule():
    tr = LocalTransition(k_fraction=0.1, k_max=7)
    table = k_table_host(300, 2, k_fraction=0.1, k_max=7)
    for c in range(3, 301):
        assert table[c] == tr._effective_k(c, 2)
    # round half to even in float64, as the host rule (0.1 * 25 = 2.5)
    assert k_table_host(64, 1, k_fraction=0.1)[25] == 2
    assert k_table_host(64, 3, k_fixed=9)[40] == 9


def _tile(rows, n, seed, n_inf):
    rng = np.random.default_rng(seed)
    sq = rng.random((rows, n)).astype(np.float32) * 4.0
    sq[:, :3] = sq[:, 3:6]  # duplicated distances (ties)
    sq[:, -n_inf:] = np.inf
    return sq


@pytest.mark.parametrize("stride", [1, 4])
@pytest.mark.parametrize("k", [5, 64, 200])
def test_threshold_selection_equals_jax_on_a_shared_tile(stride, k):
    sq = _tile(48, 512, seed=k + stride, n_inf=37)
    ji, jc, jr = jsel.threshold_neighbors(jnp.asarray(sq), k, 256,
                                          stride=stride)
    ti, tc, tr = tsel.threshold_neighbors(torch.tensor(sq), k, 256,
                                          stride=stride)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k_dyn", [4, 100])
def test_topk_set_equals_lax_top_k(k_dyn):
    sq = _tile(32, 300, seed=k_dyn, n_inf=10)
    sq[:, 50:60] = sq[:, 40:50]  # more ties
    idx, cnt = topk_neighbors(torch.tensor(sq), torch.tensor(k_dyn), 128)
    ref = np.asarray(jax.lax.top_k(-jnp.asarray(sq), 128)[1])[:, :k_dyn]
    assert np.all(cnt.numpy() == k_dyn)
    np.testing.assert_array_equal(idx.numpy()[:, :k_dyn],
                                  np.sort(ref, axis=1))
    assert np.all(idx.numpy()[:, k_dyn:] == 0)


def test_radius_bisect_and_compaction_equal_jax():
    sq = _tile(16, 200, seed=3, n_inf=20)
    np.testing.assert_array_equal(
        tsel.radius_bisect(torch.tensor(sq), 33).numpy(),
        np.asarray(jsel.radius_bisect(jnp.asarray(sq), 33)))
    r = np.full(16, 1.5, np.float32)
    ji, jc = jsel.compact_within_radius(jnp.asarray(sq), jnp.asarray(r), 50)
    ti, tc = tsel.compact_within_radius(torch.tensor(sq), torch.tensor(r),
                                        50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_apply_rowwise_blocked_semantics():
    changed = torch.tensor([False, True, False, True, True])
    prev = (torch.full((5,), 7.0),)
    (out,), nch = tsel.apply_rowwise_blocked(
        lambda x: (x * 2.0,), changed, prev, torch.arange(5.0))
    np.testing.assert_array_equal(out.numpy(), [7.0, 2.0, 7.0, 6.0, 8.0])
    assert int(nch) == 3
    (out0,), n0 = tsel.apply_rowwise_blocked(
        lambda x: (x * 0.0,), torch.zeros(5, dtype=torch.bool), prev,
        torch.arange(5.0))
    assert int(n0) == 0 and bool((out0 == 7.0).all())


def _fit_both(X, w, dim, **kw):
    jp = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), dim=dim,
                           scaling=1.0, **kw)
    tp = LocalTransition.device_fit(torch.tensor(X), torch.tensor(w),
                                    dim=dim, scaling=1.0, **kw)
    return jax.tree.map(np.asarray, jp), tp


def _assert_factors_close(tp, jp):
    np.testing.assert_allclose(tp["chols"].numpy(), jp["chols"], atol=1e-5)
    np.testing.assert_allclose(tp["logdets"].numpy(), jp["logdets"],
                               atol=1e-5)
    _row_close(tp["precs"].numpy(), jp["precs"], 1e-4)


@pytest.mark.parametrize("d,dim", [(2, 2), (4, 3)])
def test_device_fit_matches_jax(d, dim):
    X, w = _population(300, d, seed=d, n_empty=20)
    jp, tp = _fit_both(X, w, dim, k=40)
    _assert_factors_close(tp, jp)
    lc = tp["lconst"].numpy()
    live = w > 0
    want = (np.log(jp["weights"][live]) - 0.5 * (dim * math.log(2 * math.pi)
                                                 + jp["logdets"][live]))
    np.testing.assert_allclose(lc[live], want, rtol=1e-5, atol=1e-5)
    assert np.all(lc[~live] == 0.0)


def test_device_fit_update_reuses_unchanged_rows():
    """``tests/test_select.py``'s first reuse case: the same population
    factorizes no row; a fresh one changes (nearly) every row, as the JAX
    package counts them."""
    rng = np.random.default_rng(5)
    n, dim = 200, 2
    X = rng.normal(size=(n, dim)).astype(np.float32)
    w = np.full(n, 1.0 / n, np.float32)
    kw = dict(dim=dim, scaling=1.0, k=50)
    jbase = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), **kw)
    base = convert.local_transition_params(jax.tree.map(np.asarray, jbase),
                                           device="cpu")
    _js, jn = JLocal.device_fit_update(jnp.asarray(X), jnp.asarray(w),
                                       jbase, **kw)
    same, nch = LocalTransition.device_fit_update(
        torch.tensor(X), torch.tensor(w), base, **kw)
    assert int(nch) == int(jn) == 0
    for key in ("chols", "precs", "logdets"):
        np.testing.assert_array_equal(same[key].numpy(), base[key].numpy())
    X2 = rng.normal(size=(n, dim)).astype(np.float32)
    jupd, jn2 = JLocal.device_fit_update(jnp.asarray(X2), jnp.asarray(w),
                                         jbase, **kw)
    upd, nch2 = LocalTransition.device_fit_update(
        torch.tensor(X2), torch.tensor(w), base, **kw)
    assert int(nch2) == int(jn2) > n * 0.9
    _assert_factors_close(upd, jax.tree.map(np.asarray, jupd))


def test_device_fit_update_partial_change_counts_equal():
    """``tests/test_select.py``'s second reuse case: nudging one member of
    a far cluster changes only its neighbourhoods, the same rows in both
    packages."""
    rng = np.random.default_rng(6)
    n, dim = 300, 2
    X = rng.normal(size=(n, dim)).astype(np.float32)
    X[250:] += 100.0
    w = np.full(n, 1.0 / n, np.float32)
    kw = dict(dim=dim, scaling=1.0, k=20)
    jbase = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), **kw)
    base = convert.local_transition_params(jax.tree.map(np.asarray, jbase),
                                           device="cpu")
    X2 = X.copy()
    X2[260] += 1.0
    jupd, jn = JLocal.device_fit_update(jnp.asarray(X2), jnp.asarray(w),
                                        jbase, **kw)
    upd, nch = LocalTransition.device_fit_update(
        torch.tensor(X2), torch.tensor(w), base, **kw)
    assert 0 < int(nch) == int(jn) <= 60
    _assert_factors_close(upd, jax.tree.map(np.asarray, jupd))


def test_rank_deficient_row_takes_the_same_ladder_rung():
    rng = np.random.default_rng(8)
    good = rng.normal(size=(6, 3, 3)).astype(np.float32)
    covs = np.einsum("nij,nkj->nik", good, good) + 0.1 * np.eye(3)
    v = np.array([1.0, 2.0, -1.0], np.float32)
    covs[1] = np.outer(v, v)                       # rank 1
    covs[2] = np.diag([1.0, 1.0, -1e-9]).astype(np.float32)
    covs[3] = np.diag([1.0, 1.0, -1e-6]).astype(np.float32)
    covs = covs.astype(np.float32)
    jch, jused, _bad = jutil.device_chol_guarded_batched(jnp.asarray(covs))
    tch, tused, _tbad = device_chol_guarded_batched(torch.tensor(covs))
    np.testing.assert_array_equal(tused.numpy(), np.asarray(jused))
    np.testing.assert_allclose(tch.numpy(), np.asarray(jch), atol=1e-5,
                               equal_nan=True)
    vmask = jnp.ones(3, jnp.float32)
    jc, jpr, jld = JLocal._device_factorize(jnp.asarray(covs), vmask,
                                            vmask[:, None] * vmask[None, :])
    tc, tpr, tld = factorize_plain(torch.tensor(covs), 3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(tld.numpy(), np.asarray(jld), atol=1e-4)


def test_factorization_reports_every_changed_row():
    X, w = _population(128, 2, seed=9)
    tr = LocalTransition()
    zero = tr.zero_params(128, 2, "cpu")
    field = local_cov(torch.tensor(X), torch.tensor(w),
                      **LocalTransition.field_config(128, 2, scaling=1.0,
                                                     k=10))
    _p, n_all = local_factor(field, zero, dim=2, incremental=True)
    assert int(n_all) == 128
    flag0 = torch.zeros((), dtype=torch.int32)
    kept, n0 = local_factor(field, zero, dim=2, incremental=True, flag=flag0)
    assert int(n0) == 0
    for k in ("thetas", "weights", "chols", "lconst"):
        assert bool((kept[k] == zero[k]).all())


def _bimodal_fit():
    """Modes at +-500 with a local bandwidth of ~0.05: the case where the
    centred expansion loses ~5e6 nats in float32."""
    rng = np.random.default_rng(11)
    X = np.concatenate([rng.normal(-500.0, 0.05, size=(100, 2)),
                        rng.normal(500.0, 0.05, size=(100, 2))])
    return X.astype(np.float32), np.full(200, 1 / 200, np.float32)


@pytest.mark.parametrize("case", ["gauss", "bimodal"])
def test_density_matches_jax(case):
    if case == "gauss":
        X, w = _population(256, 3, seed=12, n_empty=16)
        q = np.random.default_rng(13).normal(size=(500, 3)).astype(
            np.float32)
    else:
        X, w = _bimodal_fit()
        rng = np.random.default_rng(14)
        q = np.concatenate([X[:50] + rng.normal(0, 0.05, (50, 2)),
                            X[150:] + rng.normal(0, 0.05, (50, 2)),
                            rng.normal(0, 300, (20, 2))]).astype(np.float32)
    jp = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), dim=X.shape[1],
                           scaling=1.0, k=20)
    ref = np.asarray(jax.vmap(lambda th: JLocal.device_logpdf(th, jp))(
        jnp.asarray(q)))
    params = convert.local_transition_params(jax.tree.map(np.asarray, jp),
                                             device="cpu")
    got = local_logpdf(torch.tensor(q), params).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


def test_local_transition_params_carry_a_jax_fit_across():
    X, w = _population(200, 2, seed=15, n_empty=10)
    jp = jax.tree.map(np.asarray, JLocal.device_fit(
        jnp.asarray(X), jnp.asarray(w), dim=2, scaling=1.0, k=25))
    params = convert.local_transition_params(jp, device="cpu")
    assert set(params) == {"thetas", "weights", "chols", "precs", "logdets",
                           "cdf", "lconst", "dim"}
    assert params["dim"] == 2.0
    tp = LocalTransition.device_fit(torch.tensor(X), torch.tensor(w), dim=2,
                                    scaling=1.0, k=25)
    q = torch.tensor(np.random.default_rng(16).normal(size=(300, 2)),
                     dtype=torch.float32)
    np.testing.assert_allclose(local_logpdf(q, params).numpy(),
                               local_logpdf(q, tp).numpy(), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(params["cdf"].numpy(), tp["cdf"].numpy(),
                               rtol=1e-5)


def test_draw_is_jax_formula_on_the_same_numbers():
    """K2's local mode: given the port's own uniforms and normals, theta is
    thetas[idx] + chols[idx] z with idx from ``jax.random.choice``'s
    inverse CDF over JAX's weights."""
    X, w = _population(64, 3, seed=17, n_empty=5)
    jp = jax.tree.map(np.asarray, JLocal.device_fit(
        jnp.asarray(X), jnp.asarray(w), dim=3, scaling=1.0, k=12))
    params = convert.local_transition_params(jp, device="cpu")
    B = 4096
    stream = philox.PhiloxStream(3, 2, philox.TRANSITION, 256,
                                 torch.zeros(4, dtype=torch.int32))
    theta, _lp, valid = propose_local(stream, B, unbounded_prior(3, "cpu"),
                                      params)
    assert bool(valid.all())
    lanes = torch.arange(B)
    u = philox.uniforms(stream, lanes, 0, 0).numpy()
    z = philox.normals(stream, lanes, 1, 3).numpy()
    p_cuml = np.asarray(jnp.cumsum(jnp.asarray(jp["weights"])))
    r = p_cuml[-1] * u
    idx = np.asarray(jnp.searchsorted(jnp.asarray(p_cuml), jnp.asarray(r)))
    want = jp["thetas"][idx] + np.einsum("bkl,bl->bk", jp["chols"][idx], z)
    away = np.abs(p_cuml[None, :] - r[:, None]).min(axis=1) > 1e-6
    assert away.mean() > 0.99
    np.testing.assert_allclose(theta.numpy()[away], want[away], rtol=1e-5,
                               atol=1e-5)
    assert np.all(jp["weights"][idx[away]] > 0)
    # the draws' redraws keep the prior's support
    lo = torch.full((3,), -0.5)
    prior = {**unbounded_prior(3, "cpu"), "loc": lo,
             "hi": torch.full((3,), 0.5), "scale": torch.ones(3),
             "kind": torch.ones(3, dtype=torch.int32)}
    th2, _lp2, v2 = propose_local(stream, B, prior, params)
    inside = ((th2 >= -0.5) & (th2 <= 0.5)).all(dim=1)
    assert bool((inside == v2).all())


@pytest.mark.parametrize("case", ["same", "shift", "contract", "padded",
                                  "zero_fit", "zero_new"])
def test_drift_matches_jax(case):
    rng = np.random.default_rng(18)
    X = rng.normal(size=(200, 2)).astype(np.float32)
    w = np.full(200, 1 / 200, np.float32)
    Xn, wf, wn = X, w, w
    vmask = np.ones(2, np.float32)
    if case == "shift":
        Xn = X + 1.0
    elif case == "contract":
        Xn = X * 0.5
    elif case == "padded":
        vmask = np.array([1.0, 0.0], np.float32)
        Xn = X.copy()
        Xn[:, 1] += 100.0
    elif case == "zero_fit":
        wf = np.zeros_like(w)
    elif case == "zero_new":
        wn = np.zeros_like(w)
    ref = float(jutil.device_proposal_drift(
        jnp.asarray(X), jnp.asarray(wf), jnp.asarray(Xn), jnp.asarray(wn),
        jnp.asarray(vmask)))
    got = float(device_proposal_drift(
        torch.tensor(X), torch.tensor(wf), torch.tensor(Xn),
        torch.tensor(wn), torch.tensor(vmask)))
    assert got == pytest.approx(ref, rel=1e-4, abs=1e-6)
    if case.startswith("zero"):
        assert got == 0.0


@pytest.mark.parametrize("fitted,gens,drift_thr,want", [
    (False, 0, math.inf, (True, 1, 0)),     # never fitted: forced refit
    (True, 0, math.inf, (False, 0, 1)),     # tick 1 of 4
    (True, 3, math.inf, (True, 1, 0)),      # tick 4 of 4
    (True, 0, 0.5, (True, 1, 0)),           # the drift guard fires
])
def test_cadence_decision(fitted, gens, drift_thr, want):
    X = torch.tensor(np.random.default_rng(19).normal(size=(64, 2)),
                     dtype=torch.float32)
    w = torch.full((64,), 1 / 64)
    out = proposal_drift(X, w, X + 1.0, w, torch.ones(64, dtype=torch.bool),
                         dim=2, fitted=torch.tensor(fitted),
                         gens_since=torch.tensor(gens, dtype=torch.int32),
                         every=4, thr=drift_thr, min_count=3)
    assert (bool(out["refit"]), int(out["flag"]),
            int(out["gens_since"])) == want
    assert bool(out["fitted"])
    # below the refit minimum the decision stands but nothing is refit
    few = proposal_drift(X, w, X, w, torch.arange(64) < 2, dim=2,
                         fitted=torch.tensor(False),
                         gens_since=torch.tensor(0, dtype=torch.int32),
                         every=4, thr=drift_thr, min_count=3)
    assert bool(few["refit"]) and int(few["flag"]) == 0
    assert not bool(few["fitted"])


@pytest.mark.parametrize("case", ["healthy", "nan_row"])
def test_health_word_reads_local_params_as_jax(case):
    """K11's parameter check over LocalTransition's params: zero-weight
    rows (whose lconst is a finite 0) read healthy, a row whose ladder
    failed (NaN factor) sets psd_fail, as the JAX package's check over its
    params."""
    from pyabc_tpu.ops import health as jhealth
    from pyabc_tpu_torch.kernels.generation_health import params_unhealthy

    X, w = _population(96, 2, seed=20, n_empty=12)
    if case == "nan_row":
        X[5] = np.nan  # a NaN particle: its row's factor is NaN
    jp = JLocal.device_fit(jnp.asarray(X), jnp.asarray(w), dim=2,
                           scaling=1.0, k=10)
    tp = LocalTransition.device_fit(torch.tensor(X), torch.tensor(w), dim=2,
                                    scaling=1.0, k=10)
    want = bool(jhealth.params_unhealthy((jp,), jnp.asarray([True])))
    assert want == (case == "nan_row")
    assert bool(params_unhealthy(tp, torch.tensor(True))) == want
    assert not bool(params_unhealthy(tp, torch.tensor(False)))
