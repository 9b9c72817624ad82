"""Model selection (BASELINE config 5): the port's K > 1 path against the
JAX package on the CPU, module by module and whole runs.

Inputs come from numpy seeds and go through the JAX function and its
counterpart in the port (the plain PyTorch versions of the kernels): the
ModelPerturbationKernel, K26's model step, K2's model draws and per-model
proposal, K3's per-lane-model density, K8's per-model refit, K20b's ODE
family, the model terms of K5, K10 and K11, then whole runs of the
tractable pair (against the exact model posterior) and of the ODE family
(against the JAX package's own runs), the History a K = 3 run writes, and
the gates of what stays unported.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.inference.util import pad_transition_params  # noqa: E402
from pyabc_tpu.models import model_selection as jmsel  # noqa: E402
from pyabc_tpu.ops import health as jhealth  # noqa: E402
from pyabc_tpu.ops import pack as jpack  # noqa: E402
from pyabc_tpu.transition import model_perturbation as jmpk  # noqa: E402
from pyabc_tpu.transition import multivariatenormal as jmvn  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.core.random_variables import stacked_arrays  # noqa
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.generation_health import (  # noqa: E402
    generation_health_plain, params_unhealthy_models)
from pyabc_tpu_torch.kernels.model_step import model_step  # noqa: E402
from pyabc_tpu_torch.kernels.mvn_fit import mvn_fit  # noqa: E402
from pyabc_tpu_torch.kernels.mvn_logpdf import (  # noqa: E402
    mvn_mixture_logpdf)
from pyabc_tpu_torch.kernels.ode_family import (  # noqa: E402
    ode_family_simulate)
from pyabc_tpu_torch.kernels.pnorm_accept import (  # noqa: E402
    pnorm_accept_weight)
from pyabc_tpu_torch.kernels.propose import (  # noqa: E402
    model_stream, propose)
from pyabc_tpu_torch.models import model_selection as tmsel  # noqa: E402
from pyabc_tpu_torch.ops.pack import pack_models  # noqa: E402
from pyabc_tpu_torch.transition import (  # noqa: E402
    ModelPerturbationKernel, silverman_rule_of_thumb)

torch.set_num_threads(1)

DIMS = (1, 2, 2)
D_MAX = 2
K = 3
N_DRAWS = 200_000


# ----------------------------------------------------------------- MPK
@pytest.mark.parametrize("n_models", [1, 2, 3])
@pytest.mark.parametrize("stay", [None, 0.0, 0.3, 1.0])
def test_model_perturbation_kernel_matches_jax(n_models, stay):
    ours = ModelPerturbationKernel(n_models, probability_to_stay=stay)
    ref = jmpk.ModelPerturbationKernel(n_models, probability_to_stay=stay)
    assert ours.probability_to_stay == ref.probability_to_stay
    np.testing.assert_array_equal(ours._transition_matrix(),
                                  ref._transition_matrix())
    np.testing.assert_array_equal(ours.device_params(), ref.device_params())
    for a in range(n_models):
        for b in range(n_models):
            assert ours.pmf(b, a) == ref.pmf(b, a)
    draws = [ours.rvs(0, np.random.default_rng(i)) for i in range(50)]
    assert set(draws) <= {m for m in range(n_models)
                          if ours.pmf(m, 0) > 0}


# -------------------------------------------------------- K26 model step
def _jax_model_step(m, w, k_mask, fitted, mpk):
    """The JAX package's expressions (util.py:1879-1886, 1936-1947,
    1998-2001, then 1640-1652 for the next generation)."""
    m_arr, k_mask, w_norm = (jnp.asarray(m), jnp.asarray(k_mask),
                             jnp.asarray(w))
    fitted = jnp.asarray(fitted)
    model_probs_next = jnp.stack([
        jnp.where((m_arr == k) & k_mask, w_norm, 0.0).sum()
        for k in range(K)])
    counts = jnp.stack([(k_mask & (m_arr == k)).sum() for k in range(K)])
    fitted_next = (counts > 0) | (fitted & (counts > 0))
    log_model_probs = jnp.where(
        model_probs_next > 0,
        jnp.log(jnp.maximum(model_probs_next, 1e-38)), -jnp.inf)
    matrix = jnp.asarray(mpk) * fitted_next[None, :].astype(jnp.float32)
    row_sums = matrix.sum(axis=1, keepdims=True)
    matrix = jnp.where(row_sums > 0, matrix / jnp.where(row_sums > 0,
                                                        row_sums, 1.0), 0.0)
    probs = jnp.exp(log_model_probs)
    model_factor = probs @ matrix
    log_model_factor = jnp.where(
        model_factor > 0, jnp.log(jnp.maximum(model_factor, 1e-38)),
        -jnp.inf)
    return {k: np.asarray(v) for k, v in dict(
        model_probs=model_probs_next, counts=counts, fitted=fitted_next,
        log_model_probs=log_model_probs, matrix=matrix,
        log_model_factor=log_model_factor).items()}


def _step_inputs(case, n=257):
    rng = np.random.default_rng(len(case))
    m = rng.integers(0, K, n).astype(np.int32)
    k_mask = np.arange(n) < 201
    w = np.where(k_mask, rng.random(n), 0.0).astype(np.float32)
    fitted = np.ones(K, bool)
    stay = 0.7
    if case == "never_fitted":
        fitted[2] = False
        m[m == 2] = 1
    elif case == "dying":
        m[(m == 0) & k_mask] = 1
    elif case == "custom":
        stay = 0.3
        w = np.where(m == 2, 5.0 * w, w).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    mpk = jmpk.ModelPerturbationKernel(K, stay).device_params()
    return m, w, k_mask, fitted, mpk


@pytest.mark.parametrize("case", ["never_fitted", "dying", "custom"])
def test_model_step_matches_jax(case):
    m, w, k_mask, fitted, mpk = _step_inputs(case)
    ref = _jax_model_step(m, w, k_mask, fitted, mpk)
    t = torch.from_numpy
    got = model_step(t(m), t(w), t(k_mask), t(fitted), t(mpk))
    np.testing.assert_array_equal(got["fitted"].numpy(), ref["fitted"])
    np.testing.assert_array_equal(got["counts"].numpy(), ref["counts"])
    for key in ("model_probs", "log_model_probs", "matrix",
                "log_model_factor"):
        # float32 sums in another order, libm against XLA: rel 1e-6
        np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=1e-6,
                                   atol=0, err_msg=key)
    if case == "dying":
        assert int(got["counts"][0]) == 0 and not bool(got["fitted"][0])
        assert float(got["model_probs"][0]) == 0.0
        assert np.isneginf(got["log_model_probs"][0].numpy())
        # nobody proposes the dead model next generation
        assert (got["matrix"][:, 0] == 0).all()


# ------------------------------------------------------ fits (K8 and K3)
def _reservoir(seed, n=96, n_keep=80, empty_model=None):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, K, n).astype(np.int32)
    if empty_model is not None:
        m[m == empty_model] = (empty_model + 1) % K
    theta = rng.normal([0.5, 1.0], [0.2, 0.4], size=(n, D_MAX))
    theta[m == 0, 1] = 0.0  # model 0 is one-dimensional: padded with 0
    k_mask = np.arange(n) < n_keep
    w = np.where(k_mask, rng.random(n), 0.0)
    return (theta.astype(np.float32), (w / w.sum()).astype(np.float32), m,
            k_mask)


def _jax_fits(theta, w, m):
    fits = []
    for k in range(K):
        w_k = np.where(m == k, w, 0.0).astype(np.float32)
        jp = jmvn.MultivariateNormalTransition.device_fit(
            jnp.asarray(theta), jnp.asarray(w_k), dim=DIMS[k], scaling=1.0,
            bandwidth_selector=jutil.silverman_rule_of_thumb)
        fits.append(jax.tree.map(np.asarray, jp))
    return fits


STATICS = [dict(scaling=1.0, bandwidth_selector=silverman_rule_of_thumb)] * K


def test_mvn_fit_models_matches_jax_per_model():
    theta, w, m, _k = _reservoir(0, empty_model=2)
    ref = _jax_fits(theta, w, m)
    t = torch.from_numpy
    got = mvn_fit.models(t(theta), t(w), t(m), dims=DIMS, statics=STATICS)
    np.testing.assert_array_equal(got["dims"].numpy(), DIMS)
    for k in range(K):
        for key in ("thetas", "weights", "chol", "prec", "center",
                    "thetas_c", "quad", "logdet"):
            ours = got[key][k].numpy()
            if k == 2:
                # model 2 has no weight: the port stays finite (w = 0 /
                # 1e-38, a tiny positive covariance); XLA flushes the
                # float32 subnormal 1e-38 to 0 and its fit is 0 / 0 = NaN
                # (a declared difference; `fitted` masks the model out)
                assert np.isfinite(ours).all(), key
                continue
            np.testing.assert_allclose(ours, ref[k][key], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} {key}")
        # padded dims stay exactly 0 in chol, prec, center and the rows
        if DIMS[k] < D_MAX:
            assert (got["chol"][k][1:, :] == 0).all()
            assert (got["prec"][k][:, 1:] == 0).all()
            assert (got["thetas"][k][:, 1:] == 0).all()
    assert not np.isfinite(ref[2]["logdet"])


def test_mvn_logpdf_models_matches_jax_device_logpdf():
    theta, w, m, _k = _reservoir(1)
    ref_fits = _jax_fits(theta, w, m)
    padded = [jax.tree.map(np.asarray, pad_transition_params(
        f, 96, D_MAX)) for f in ref_fits]
    params = convert.stacked_transition_params(padded, device="cpu")
    rng = np.random.default_rng(2)
    B = 512
    q = rng.normal([0.5, 1.0], [0.3, 0.5], size=(B, D_MAX)).astype(
        np.float32)
    mq = rng.integers(0, K, B).astype(np.int32)
    q[mq == 0, 1] = 0.0
    got = mvn_mixture_logpdf.models(torch.from_numpy(q),
                                    torch.from_numpy(mq), params).numpy()
    for k in range(K):
        jp = jax.tree.map(jnp.asarray, padded[k])
        ref = np.asarray(jax.vmap(
            lambda x: jmvn.MultivariateNormalTransition.device_logpdf(
                x, jp))(jnp.asarray(q[mq == k])))
        np.testing.assert_allclose(got[mq == k], ref, rtol=1e-5, atol=1e-5,
                                   err_msg=f"model {k}")


def test_convert_carry_over_models():
    theta, w, m, k_mask = _reservoir(2)
    fits = _jax_fits(theta, w, m)
    step = _jax_model_step(m, w, k_mask, np.array([True, True, False]),
                           jmpk.ModelPerturbationKernel(K).device_params())
    jcarry = (tuple(fits), step["log_model_probs"], step["fitted"],
              np.ones(4, np.float32), np.float32(0.7),
              (np.float32(np.inf), np.float32(0.0), np.float32(1.0)),
              np.asarray(False), (np.float32(0.9), np.int32(2)))
    mpk = jmpk.ModelPerturbationKernel(K).device_params()
    carry = convert.carry(jcarry, device="cpu", mpk=mpk)
    assert carry.trans_params["thetas"].shape == (K, 96, D_MAX)
    np.testing.assert_array_equal(carry.trans_params["dims"].numpy(), DIMS)
    np.testing.assert_array_equal(carry.fitted.numpy(), step["fitted"])
    np.testing.assert_allclose(carry.matrix.numpy(), step["matrix"],
                               rtol=1e-6)
    np.testing.assert_allclose(carry.log_model_factor.numpy(),
                               step["log_model_factor"], rtol=1e-6)
    assert float(carry.eps) == pytest.approx(0.7)
    assert int(carry.stall_count) == 2
    with pytest.raises(ValueError, match="mpk"):
        convert.carry(jcarry, device="cpu")


# -------------------------------------------------------------- K2
def _priors():
    wide = [tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0)),
            tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0),
                             b=tpt.RV("uniform", -500.0, 1000.0)),
            tpt.Distribution(a=tpt.RV("norm", 0.0, 100.0),
                             k=tpt.RV("norm", 1.0, 100.0))]
    return stacked_arrays(wide, "cpu")


def _stream(tag, seed=5):
    return philox.PhiloxStream(seed, 3, tag, 256,
                               torch.zeros(4, dtype=torch.int32))


def test_propose_models_prior_frequencies():
    prior_p = np.array([0.2, 0.5, 0.3])
    _t, lp, valid, m = propose.models(
        _stream(philox.PRIOR), N_DRAWS, _priors(),
        torch.tensor(prior_p, dtype=torch.float32))
    freq = np.bincount(m.numpy(), minlength=K) / N_DRAWS
    se = np.sqrt(prior_p * (1 - prior_p) / N_DRAWS)
    assert (np.abs(freq - prior_p) < 5 * se).all(), (freq, prior_p)
    assert bool(valid.all()) and torch.isfinite(lp).all()
    # a zero-probability model is never drawn
    _t, _lp, _v, m0 = propose.models(
        _stream(philox.PRIOR, seed=6), 4096, _priors(),
        torch.tensor([0.5, 0.0, 0.5]))
    assert not (m0 == 1).any()


def test_propose_models_transition_frequencies_and_theta():
    theta, w, m, _k = _reservoir(3)
    fits = _jax_fits(theta, w, m)
    params = convert.stacked_transition_params(fits, device="cpu")
    probs = np.array([0.25, 0.6, 0.15], np.float32)
    fitted = np.array([True, True, False])
    mpk = jmpk.ModelPerturbationKernel(K, 0.7).device_params()
    masked = mpk * fitted[None, :]
    masked = masked / masked.sum(axis=1, keepdims=True)
    stream = _stream(philox.TRANSITION)
    th, _lp, valid, mm = propose.models(
        stream, N_DRAWS, _priors(), torch.from_numpy(np.log(probs)),
        params, torch.from_numpy(masked.astype(np.float32)))
    assert bool(valid.all())
    want = probs @ masked
    freq = np.bincount(mm.numpy(), minlength=K) / N_DRAWS
    se = np.sqrt(want * (1 - want) / N_DRAWS) + 1e-12
    assert (np.abs(freq - want) < 5 * se).all(), (freq, want)
    assert want[2] == 0 and freq[2] == 0
    # theta from (m, ancestor, z) on the port's own numbers: redraw 0 takes
    # the uniform of block 0 word 0 and the normals from block 1
    lanes = torch.arange(N_DRAWS)
    u = philox.uniforms(stream, lanes, 0, 0).numpy()
    z = philox.normals(stream, lanes, 1, D_MAX).numpy()
    mm, th = mm.numpy(), th.numpy()
    for k in range(2):
        sel = mm == k
        p_cuml = np.cumsum(fits[k]["weights"], dtype=np.float32)
        r = p_cuml[-1] * u[sel]
        idx = np.searchsorted(p_cuml, r, side="right")
        want_th = fits[k]["thetas"][idx] + z[sel] @ fits[k]["chol"].T
        away = np.abs(p_cuml[None, :] - r[:, None]).min(axis=1) > 1e-6
        np.testing.assert_allclose(th[sel][away], want_th[away],
                                   rtol=1e-5, atol=1e-6)
        if DIMS[k] < D_MAX:
            assert (th[sel][:, 1:] == 0).all()
    # the draws of the model index sit on the MODEL stream only
    assert model_stream(stream).tag == philox.MODEL == 5


def test_convert_carry_over_models():
    theta, w, m, k_mask = _reservoir(2)
    fits = _jax_fits(theta, w, m)
    step = _jax_model_step(m, w, k_mask, np.array([True, True, False]),
                           jmpk.ModelPerturbationKernel(K).device_params())
    jcarry = (tuple(fits), step["log_model_probs"], step["fitted"],
              np.ones(4, np.float32), np.float32(0.7),
              (np.float32(np.inf), np.float32(0.0), np.float32(1.0)),
              np.asarray(False), (np.float32(0.9), np.int32(2)))
    mpk = jmpk.ModelPerturbationKernel(K).device_params()
    carry = convert.carry(jcarry, device="cpu", mpk=mpk)
    assert carry.trans_params["thetas"].shape == (K, 96, D_MAX)
    np.testing.assert_array_equal(carry.trans_params["dims"].numpy(), DIMS)
    np.testing.assert_array_equal(carry.fitted.numpy(), step["fitted"])
    np.testing.assert_allclose(carry.matrix.numpy(), step["matrix"],
                               rtol=1e-6)
    np.testing.assert_allclose(carry.log_model_factor.numpy(),
                               step["log_model_factor"], rtol=1e-6)
    assert float(carry.eps) == pytest.approx(0.7)
    assert int(carry.stall_count) == 2
    with pytest.raises(ValueError, match="mpk"):
        convert.carry(jcarry, device="cpu")


# -------------------------------------------------------------- K20b
def test_ode_family_matches_jax_models():
    rng = np.random.default_rng(4)
    B = 64
    theta = np.stack([rng.uniform(0.05, 1.05, B), rng.uniform(1.0, 10.0, B)],
                     axis=1).astype(np.float32)
    mm = rng.integers(0, K, B).astype(np.int32)
    theta[mm == 0, 1] = 0.0
    fam = tmsel.ode_family()[0][0].family
    kw = dict(n_obs=fam.n_obs, n_substeps=fam.n_substeps, dt=fam.dt)
    jmodels0 = jmsel.ode_family(noise_sd=0.0)[0]
    jmodels = jmsel.ode_family()[0]
    keys = jax.random.split(jax.random.key(7), B)
    noise = np.stack([np.asarray(jax.random.normal(keys[b], (fam.n_obs,)))
                      for b in range(B)]).astype(np.float32)
    t = torch.from_numpy
    det = ode_family_simulate(t(theta), t(mm), noise_sd=0.0, **kw).numpy()
    noisy = ode_family_simulate(t(theta), t(mm), noise_sd=0.3,
                                noise=t(noise), **kw).numpy()
    for k in range(K):
        sel = mm == k
        th = jnp.asarray(theta[sel, :DIMS[k]])
        ref0 = np.asarray(jax.vmap(jmodels0[k].sim)(keys[sel], th)["y"])
        ref = np.asarray(jax.vmap(jmodels[k].sim)(keys[sel], th)["y"])
        # float32 RK4 in the same operation order: rel 1e-5
        np.testing.assert_allclose(det[sel], ref0, rtol=1e-5,
                                   err_msg=str(k))
        np.testing.assert_allclose(noisy[sel], ref, atol=1e-5,
                                   err_msg=str(k))


def test_observed_ode_family_is_the_family_plus_numpy_noise():
    obs = tmsel.observed_ode_family(seed=0, true_model=1)["y"]
    clean = tmsel.observed_ode_family(seed=0, true_model=1,
                                      noise_sd=0.0)["y"]
    noise = np.random.default_rng(0).standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(obs, clean + np.float32(0.3) * noise,
                               atol=1e-6)
    ref = np.asarray(jmsel.ode_family(noise_sd=0.0)[0][1].sim(
        jax.random.key(0), jnp.asarray([0.4, 0.5]))["y"])
    np.testing.assert_allclose(clean, ref, rtol=1e-5)


# ------------------------------------------------ K5, K10, K11 (K > 1)
def test_log_weight_with_model_terms_matches_jax_formula():
    rng = np.random.default_rng(5)
    B, S = 300, 12
    ss = rng.normal(size=(B, S)).astype(np.float32)
    x0 = np.zeros(S, np.float32)
    mm = rng.integers(0, K, B).astype(np.int32)
    logpri = rng.normal(size=B).astype(np.float32)
    logq = rng.normal(size=B).astype(np.float32)
    valid = rng.random(B) > 0.1
    # a custom model prior and a factor with a dead model
    logits = np.log(np.array([0.2, 0.5, 0.3])).astype(np.float32)
    lmf = np.array([-1.2, -0.4, -np.inf], np.float32)
    t = torch.from_numpy
    _d, _a, lw = pnorm_accept_weight(
        t(ss), t(x0), torch.ones(S), torch.tensor(2.0), t(valid), p=2.0,
        logpri=t(logpri), logq=t(logq), m=t(mm), model_logits=t(logits),
        log_model_factor=t(lmf))
    jm = jnp.asarray(mm)
    log_acc_w = jnp.zeros(B)
    ref = (jnp.asarray(logits)[jm] + jnp.asarray(logpri) + log_acc_w
           - jnp.asarray(lmf)[jm] - jnp.asarray(logq))
    ref = np.asarray(jnp.where(jnp.asarray(valid), ref, -jnp.inf))
    np.testing.assert_allclose(lw.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32"])
def test_pack_models_matches_jax_pack_outs(name):
    rng = np.random.default_rng(6)
    G, n_cap, n_keep = 3, 64, 50
    ms = rng.integers(0, K, (G, n_cap)).astype(np.int32)
    outs = {"theta": jnp.zeros((G, n_cap, D_MAX)),
            "distance": jnp.zeros((G, n_cap)),
            "log_weight": jnp.zeros((G, n_cap)), "m": jnp.asarray(ms)}
    ref = jpack.pack_outs(outs, n_keep=n_keep,
                          dtype=jpack.fetch_dtype_of(name), keep_m=True,
                          ss_gens=())
    got = pack_models([torch.from_numpy(x) for x in ms], n_keep=n_keep)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref["m"]))


@pytest.mark.parametrize("kind", ["ok", "fitted_nan", "unfitted_nan",
                                  "fitted_zero_weight"])
def test_health_over_model_fits_matches_jax(kind):
    theta, w, m, k_mask = _reservoir(8)
    fits = _jax_fits(theta, w, m)
    fitted = np.array([True, True, kind != "unfitted_nan"])
    if kind in ("fitted_nan", "unfitted_nan"):
        fits[2]["chol"] = np.full_like(fits[2]["chol"], np.nan)
    elif kind == "fitted_zero_weight":
        fits[1]["weights"] = np.zeros_like(fits[1]["weights"])
    jfits = tuple(jax.tree.map(jnp.asarray, f) for f in fits)
    params = convert.stacked_transition_params(fits, device="cpu")
    jbad = bool(jhealth.params_unhealthy(jfits, jnp.asarray(fitted)))
    tbad = bool(params_unhealthy_models(params, torch.from_numpy(fitted)))
    assert tbad == jbad == (kind in ("fitted_nan", "fitted_zero_weight"))
    cfg = dict(ess_floor=0.2, acc_floor=0.0, stall_window=0, stall_rtol=0.0)
    d_new = np.random.default_rng(9).exponential(size=len(w)).astype(
        np.float32)
    n_acc = int(k_mask.sum())
    word, ess, _ep, _st = jhealth.generation_health(
        res={"theta": jnp.asarray(theta)}, k_mask=jnp.asarray(k_mask),
        w_norm=jnp.asarray(w), d_new=jnp.asarray(d_new),
        n_acc=jnp.int32(n_acc), n_target=n_acc, acc_rate=jnp.float32(0.5),
        trans_params=jfits, trans_next=jfits, fitted=jnp.asarray(fitted),
        fitted_next=jnp.asarray(fitted), eps_g=jnp.float32(0.5),
        eps_next=jnp.float32(0.4), eps_prev=jnp.float32(1.0),
        stall_count=jnp.int32(0), **cfg)
    f = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    t = torch.from_numpy
    tword, tess, _tep, _tst = generation_health_plain(
        theta=t(theta), k_mask=t(k_mask), w_norm=t(w), d_new=t(d_new),
        n_acc=torch.tensor(n_acc, dtype=torch.int32), n_target=n_acc,
        acc_rate=f(0.5), trans_params=params, trans_next=params,
        fitted=t(fitted), fitted_next=t(fitted), eps_g=f(0.5),
        eps_next=f(0.4), eps_prev=f(1.0),
        stall_count=torch.tensor(0, dtype=torch.int32), **cfg)
    assert int(tword) == int(word)
    np.testing.assert_allclose(float(tess), float(ess), rtol=1e-5)


# --------------------------------------------------------- whole runs
def test_tractable_pair_matches_the_exact_model_posterior():
    models, priors, analytic = tmsel.tractable_pair()
    jref = jmsel.tractable_pair()[2]
    np.testing.assert_allclose(analytic(1.0), jref(1.0), rtol=1e-12)
    np.testing.assert_allclose(analytic(0.7), [0.5529, 0.4471], atol=1e-4)
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=600, eps=tpt.MedianEpsilon(), seed=7,
                     device="cpu")
    abc.new("sqlite://", {"x": 1.0})
    h = abc.run(max_nr_populations=6)
    assert h.n_populations == 6
    probs = h.get_model_probabilities(h.max_t)["p"]
    # the JAX test's own bound (tests/test_multimodel.py): finite eps
    for k in range(2):
        assert float(probs.get(k, 0.0)) == pytest.approx(
            analytic(1.0)[k], abs=0.15)
    assert abc.model_probs and sum(abc.model_probs.values()) == \
        pytest.approx(1.0, abs=1e-5)


ODE_SEEDS = (10, 11, 12)


def test_ode_family_runs_beside_the_jax_package():
    obs = jmsel.observed_ode_family(seed=3, true_model=1, n_obs=8, t1=6.0)
    obs = {k: np.asarray(v) for k, v in obs.items()}
    ours, theirs = [], []
    jctx = None
    jmodels, jpriors, _ts = jmsel.ode_family(n_obs=8, t1=6.0)
    for seed in ODE_SEEDS:
        models, priors, _t = tmsel.ode_family(n_obs=8, t1=6.0)
        abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                         population_size=250, seed=seed, device="cpu")
        abc.new("sqlite://", obs)
        h = abc.run(max_nr_populations=4)
        p = h.get_model_probabilities(h.max_t)["p"]
        assert p.sum() == pytest.approx(1.0)
        assert float(p.get(0, 0.0)) < 0.9
        ours.append([float(p.get(k, 0.0)) for k in range(K)])
        # the JAX runs share one device context, so its kernels compile
        # once for the three seeds
        jabc = jpt.ABCSMC(jmodels, jpriors, jpt.PNormDistance(p=2),
                          population_size=250, seed=seed)
        jabc.new("sqlite://", obs)
        if jctx is not None:
            jabc._device_ctx = jctx
        jh = jabc.run(max_nr_populations=4)
        jctx = jabc._device_ctx
        jp = jh.get_model_probabilities(jh.max_t)["p"]
        theirs.append([float(jp.get(k, 0.0)) for k in range(K)])
    gap = np.abs(np.mean(ours, axis=0) - np.mean(theirs, axis=0))
    assert (gap < 0.2).all(), (ours, theirs)


def test_jax_history_reads_a_port_k3_db(tmp_path):
    db = "sqlite:///" + str(tmp_path / "k3.db")
    models, priors, _t = tmsel.ode_family()
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=100, seed=2, device="cpu",
                     fused_generations=2)
    abc.new(db, tmsel.observed_ode_family(seed=0))
    h = abc.run(max_nr_populations=3)
    jh = jpt.History(db)
    assert jh.max_t == h.max_t == 2
    assert jh.alive_models() == h.alive_models()
    assert jh.n_alive_models(1) == h.n_alive_models(1)
    for t in range(3):
        pj = jh.get_model_probabilities(t)
        pt_ = h.get_model_probabilities(t)
        np.testing.assert_allclose(pj["p"].to_numpy(), pt_["p"].to_numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(pj["p"].sum(), 1.0)
        for m in h.alive_models(t):
            df_j, w_j = jh.get_distribution(m, t)
            df_t, w_t = h.get_distribution(m, t)
            assert list(df_j.columns) == list(priors[m].space.names)
            np.testing.assert_array_equal(df_j.to_numpy(), df_t.to_numpy())
            np.testing.assert_allclose(w_j, w_t, rtol=1e-12)
    all_j, all_t = (jh.get_model_probabilities(),
                    h.get_model_probabilities())
    np.testing.assert_allclose(all_j.to_numpy(), all_t.to_numpy(),
                               rtol=1e-12)


def test_stop_if_only_single_model_alive():
    models, priors, _a = tmsel.tractable_pair()
    abc = tpt.ABCSMC(models, priors, tpt.PNormDistance(p=2),
                     population_size=200, seed=3, device="cpu",
                     model_prior=[1.0, 0.0],
                     stop_if_only_single_model_alive=True)
    abc.new("sqlite://", {"x": 0.5})
    h = abc.run(max_nr_populations=5)
    # the model prior excludes model 1: only model 0 is alive after the
    # first generation, and the rule stops the run there
    assert h.n_populations == 1 and h.alive_models() == [0]
    assert abc.model_probs == {0: pytest.approx(1.0)}


# -------------------------------------------------------------- gates
def test_gates_of_what_is_not_ported():
    models, priors, _a = tmsel.tractable_pair()
    with pytest.raises(ValueError, match="StochasticAcceptor"):
        tpt.ABCSMC(models, priors, tpt.IndependentNormalKernel(var=[0.1]),
                   eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor(),
                   device="cpu")
    # the segmented family builds (K18 steps it under early reject); a
    # LocalTransition over several models runs, but under segmented early
    # reject it is still to port
    seg_models, seg_priors, _ts = tmsel.ode_family(segments=4)
    assert all(m.segmented is not None for m in seg_models)
    abc = tpt.ABCSMC(seg_models, seg_priors,
                     transitions=[tpt.LocalTransition() for _ in seg_models],
                     population_size=64, device="cpu")
    abc.new("sqlite://", tmsel.observed_ode_family(seed=0, true_model=1,
                                                   segments=4))
    with pytest.raises(NotImplementedError, match="item 12"):
        abc.run(max_nr_populations=2)
