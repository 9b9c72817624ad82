"""K2: the proposal of one round (``kernels/propose.py``, plain PyTorch on
the CPU) against the JAX package's ``MultivariateNormalTransition.device_rvs``
and ``Distribution.rvs_array`` / ``logpdf_array``.

JAX's threefry draws cannot be fed to the port, so there are two checks:
given the port's own uniforms and normals, theta equals thetas[idx] +
chol z computed in numpy from JAX's fit with ``jax.random.choice``'s
inverse CDF; and 2e5 proposals of each package agree in distribution.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import stats as sps  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.transition import multivariatenormal as jmvn  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu_torch import RV, Distribution, convert  # noqa: E402
from pyabc_tpu_torch.kernels import philox  # noqa: E402
from pyabc_tpu_torch.kernels.propose import (  # noqa: E402
    prior_logpdf_plain, propose, unbounded_prior)

torch.set_num_threads(1)

N_DRAWS = 200_000


def _jax_fit(n, d, seed, scaling=1.0, n_empty=3):
    rng = np.random.default_rng(seed)
    thetas = rng.normal(1.0, 0.5, size=(n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[n - n_empty:] = 0.0
    w /= w.sum()
    jp = jmvn.MultivariateNormalTransition.device_fit(
        jnp.asarray(thetas), jnp.asarray(w), dim=d, scaling=scaling,
        bandwidth_selector=jutil.silverman_rule_of_thumb)
    return jax.tree.map(np.asarray, jp)


def _stream(tag=philox.TRANSITION, seed=3):
    return philox.PhiloxStream(seed, 2, tag, 256,
                               torch.zeros(4, dtype=torch.int32))


def _priors(d):
    spec = [(f"p{k}", "uniform" if k % 2 else "norm",
             -0.5 if k % 2 else 1.0, 3.0 if k % 2 else 0.7)
            for k in range(d)]
    jprior = jpt.Distribution(**{n: jpt.RV(f, a, b) for n, f, a, b in spec})
    return jprior, Distribution(**{n: RV(f, a, b) for n, f, a, b in spec})


@pytest.mark.parametrize("d", [1, 2, 4, 5])
def test_theta_matches_jax_inverse_cdf_on_the_same_numbers(d):
    jp = _jax_fit(64, d, seed=d)
    params = convert.transition_params(jp, device="cpu")
    B = 4096
    stream = _stream()
    theta, _lp, valid = propose(stream, B, unbounded_prior(d, "cpu"), params)
    assert bool(valid.all())
    # redraw 0's numbers: block 0 word 0 and the normals from block 1
    lanes = torch.arange(B)
    u = philox.uniforms(stream, lanes, 0, 0).numpy()
    z = philox.normals(stream, lanes, 1, d).numpy()
    # jax.random.choice: p_cuml[-1] * (1 - uniform), searchsorted left;
    # its uniform is 1 - u here (exact in float32), so r = total * u
    p_cuml = np.asarray(jnp.cumsum(jnp.asarray(jp["weights"])))
    r = p_cuml[-1] * (np.float32(1) - (np.float32(1) - u))
    idx = np.asarray(jnp.searchsorted(jnp.asarray(p_cuml), jnp.asarray(r)))
    want = jp["thetas"][idx] + z @ jp["chol"].T
    away = np.abs(p_cuml[None, :] - r[:, None]).min(axis=1) > 1e-6
    assert away.mean() > 0.99
    # the same float32 numbers, the product summed in another order
    np.testing.assert_allclose(theta.numpy()[away], want[away], rtol=1e-5,
                               atol=1e-5)
    # empty (zero-weight) slots are never ancestors
    assert np.all(jp["weights"][idx[away]] > 0)


@pytest.mark.parametrize("d", [1, 3, 4])
def test_logpri_matches_jax_logpdf_array(d):
    jprior, prior = _priors(d)
    jp = _jax_fit(128, d, seed=10 + d)
    params = convert.transition_params(jp, device="cpu")
    theta, lp, valid = propose(_stream(), 2048, prior.arrays("cpu"),
                               params)
    ref = np.asarray(jax.vmap(jprior.logpdf_array)(jnp.asarray(
        theta.numpy())))
    # float32 densities summed dim by dim in the same order: 1e-6
    np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.isfinite(ref))
    # redraws against zero prior mass left few lanes without support
    assert valid.float().mean() > 0.9 and (~np.isfinite(ref)).sum() == \
        int((~valid).sum())
    plain = prior_logpdf_plain(theta, prior.arrays("cpu")).numpy()
    np.testing.assert_array_equal(plain, lp.numpy())


def _moments_agree(a, b):
    """Means and covariance entries of two samples within 4 se."""
    n_a, n_b = len(a), len(b)
    se_m = np.sqrt(a.var(0) / n_a + b.var(0) / n_b)
    assert np.all(np.abs(a.mean(0) - b.mean(0)) < 4 * se_m)
    ca, cb = a - a.mean(0), b - b.mean(0)
    for k in range(a.shape[1]):
        for m in range(k, a.shape[1]):
            pa, pb = ca[:, k] * ca[:, m], cb[:, k] * cb[:, m]
            se = np.sqrt(pa.var() / n_a + pb.var() / n_b)
            assert abs(pa.mean() - pb.mean()) < 4 * se, (k, m)


def test_proposals_match_jax_device_rvs_in_distribution():
    jp = _jax_fit(16, 2, seed=4)
    params = convert.transition_params(jp, device="cpu")
    port, _, _ = propose(_stream(seed=9), N_DRAWS,
                         unbounded_prior(2, "cpu"), params)
    keys = jax.random.split(jax.random.key(9), N_DRAWS)
    ref = np.asarray(jax.vmap(
        jmvn.MultivariateNormalTransition.device_rvs,
        in_axes=(0, None))(keys, jax.tree.map(jnp.asarray, jp)))
    _moments_agree(port.numpy().astype(np.float64), ref.astype(np.float64))


def test_ancestor_frequencies_match_jax():
    # a vanishing bandwidth returns the ancestors themselves
    jp = _jax_fit(16, 2, seed=5, scaling=1e-5)
    params = convert.transition_params(jp, device="cpu")
    port, _, _ = propose(_stream(seed=1), N_DRAWS,
                         unbounded_prior(2, "cpu"), params)
    keys = jax.random.split(jax.random.key(1), N_DRAWS)
    ref = np.asarray(jax.vmap(
        jmvn.MultivariateNormalTransition.device_rvs,
        in_axes=(0, None))(keys, jax.tree.map(jnp.asarray, jp)))

    def counts(x):
        dist = np.abs(x[:, None, :] - jp["thetas"][None]).sum(-1)
        return np.bincount(dist.argmin(1), minlength=16)

    cp, cj = counts(port.numpy()), counts(ref)
    live = jp["weights"] > 0
    assert cp[~live].sum() == 0 and cj[~live].sum() == 0
    _chi2, p, _dof, _exp = sps.chi2_contingency(np.stack([cp[live],
                                                          cj[live]]))
    assert p > 1e-3
    # and each against the weights themselves
    w = jp["weights"][live].astype(np.float64)
    exp = w / w.sum() * cp[live].sum()
    assert sps.chisquare(cp[live], exp).pvalue > 1e-3


def test_prior_draws_match_jax_rvs_array():
    jprior, prior = _priors(3)
    port, lp, valid = propose(_stream(philox.PRIOR), N_DRAWS,
                              prior.arrays("cpu"))
    assert bool(valid.all()) and bool(torch.isfinite(lp).all())
    keys = jax.random.split(jax.random.key(2), N_DRAWS)
    ref = np.asarray(jax.vmap(jprior.rvs_array)(keys))
    _moments_agree(port.numpy().astype(np.float64), ref.astype(np.float64))
    # uniform dims stay on their support
    assert port[:, 1].min() >= -0.5 and port[:, 1].max() <= 2.5
