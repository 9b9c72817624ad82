"""Port parity: K3 (MVN mixture log-density) and the MVN refit (K8).

The same numpy inputs go through the JAX package's
``MultivariateNormalTransition.device_fit`` / ``device_logpdf`` and the
port's counterparts (plain PyTorch on the CPU); JAX's fitted params cross
over through ``pyabc_tpu_torch.convert``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pyabc_tpu.transition import multivariatenormal as jmvn  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
from pyabc_tpu_torch import convert  # noqa: E402
from pyabc_tpu_torch.kernels import mvn_mixture_logpdf  # noqa: E402
from pyabc_tpu_torch.kernels.philox import (PhiloxStream,  # noqa: E402
                                            TRANSITION)
from pyabc_tpu_torch.transition import (  # noqa: E402
    MultivariateNormalTransition, scott_rule_of_thumb,
    silverman_rule_of_thumb)
from pyabc_tpu_torch.transition import util as transition_util  # noqa: E402

torch.set_num_threads(1)

SELECTORS = {"silverman": (jutil.silverman_rule_of_thumb,
                           silverman_rule_of_thumb),
             "scott": (jutil.scott_rule_of_thumb, scott_rule_of_thumb)}


def _population(seed, n, d, n_empty, loc=3.0):
    """Reservoir-like input: n rows, the last n_empty are empty slots
    (zero rows, zero weight); the mean sits far from the origin so the
    centred expansion matters."""
    rng = np.random.default_rng(seed)
    thetas = rng.normal(loc, 0.4, size=(n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    thetas[n - n_empty:] = 0.0
    w[n - n_empty:] = 0.0
    return thetas, (w / w.sum()).astype(np.float32)


def _fit_both(thetas, w, d, sel):
    jsel, tsel = SELECTORS[sel]
    jp = jmvn.MultivariateNormalTransition.device_fit(
        jnp.asarray(thetas), jnp.asarray(w), dim=d, scaling=1.0,
        bandwidth_selector=jsel)
    tp = MultivariateNormalTransition.device_fit(
        torch.from_numpy(thetas), torch.from_numpy(w), dim=d, scaling=1.0,
        bandwidth_selector=tsel)
    return jax.tree.map(np.asarray, jp), tp


@pytest.mark.parametrize("d,sel", [(1, "silverman"), (2, "scott"),
                                   (4, "silverman"), (4, "scott")])
def test_device_fit_matches_jax(d, sel):
    thetas, w = _population(d, 256, d, 40)
    jp, tp = _fit_both(thetas, w, d, sel)
    # float32 moments summed in another order; the precision is an
    # inverse, so its error grows with the condition number: rtol 1e-4
    for k in ("chol", "prec", "logdet", "quad", "center", "thetas_c",
              "weights"):
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert tp["dim"] == float(jp["dim"])


@pytest.mark.parametrize("d", [1, 2, 4])
def test_mixture_logpdf_matches_jax(d):
    thetas, w = _population(10 + d, 128, d, 16)
    jp, _ = _fit_both(thetas, w, d, "silverman")
    rng = np.random.default_rng(d)
    q = (thetas[:64] + rng.normal(0, 0.3, size=(64, d))).astype(np.float32)
    q[0] = 50.0  # far tail: the log-density is very negative, not -inf
    ref = np.asarray(jax.vmap(
        jmvn.MultivariateNormalTransition.device_logpdf,
        in_axes=(0, None))(jnp.asarray(q), jp))
    got = mvn_mixture_logpdf(
        torch.from_numpy(q),
        convert.transition_params(jp, device="cpu")).numpy()
    # the same centred expansion in float32; logsumexp over 112 live
    # components summed in another order: |err| <= 1e-4 + 1e-5 |ref|
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)


def test_all_zero_weights_give_minus_inf():
    thetas, w = _population(3, 32, 2, 0)
    jp, _ = _fit_both(thetas, w, 2, "scott")
    jp["weights"] = np.zeros_like(jp["weights"])
    q = thetas[:4]
    ref = np.asarray(jax.vmap(
        jmvn.MultivariateNormalTransition.device_logpdf,
        in_axes=(0, None))(jnp.asarray(q), jp))
    got = mvn_mixture_logpdf(
        torch.from_numpy(q),
        convert.transition_params(jp, device="cpu")).numpy()
    assert np.all(np.isneginf(ref)) and np.all(np.isneginf(got))


def test_port_fit_then_logpdf_matches_jax_pipeline():
    """The port's own fit feeding K3 against JAX's fit feeding JAX's
    logpdf: the pipeline a generation runs."""
    thetas, w = _population(7, 200, 4, 8)
    jp, tp = _fit_both(thetas, w, 4, "silverman")
    q = thetas[:50] + np.float32(0.05)
    ref = np.asarray(jax.vmap(
        jmvn.MultivariateNormalTransition.device_logpdf,
        in_axes=(0, None))(jnp.asarray(q), jp))
    got = MultivariateNormalTransition.device_logpdf(
        torch.from_numpy(q), tp).numpy()
    # two float32 fits (rtol 1e-4 on prec) then the mixture: atol 1e-3
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)


def test_rvs_picks_only_weighted_rows():
    thetas, w = _population(5, 64, 2, 20)
    tp = MultivariateNormalTransition.device_fit(
        torch.from_numpy(thetas), torch.from_numpy(w), dim=2, scaling=1e-6,
        bandwidth_selector=silverman_rule_of_thumb)
    stream = PhiloxStream(0, 1, TRANSITION, 256,
                          torch.zeros(4, dtype=torch.int32))
    draws = MultivariateNormalTransition.device_rvs(tp, 4000,
                                                    stream).numpy()
    # a vanishing bandwidth returns the ancestors themselves: never an
    # empty (zero-weight) slot, whose rows sit at the origin
    assert np.all(np.abs(draws).sum(1) > 1.0)


def _edge_population(case):
    rng = np.random.default_rng(3)
    n, d = 96, 4
    thetas = rng.normal(2.0, 0.5, size=(n, d)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[80:] = 0.0  # empty reservoir slots
    thetas[80:] = 0.0
    dim = d
    if case == "one_row":
        w[:] = 0.0
        w[7] = 1.0
    elif case == "heavy_row":
        w[7] = 50.0 * w[:80].sum()
    elif case == "dim_lt_dmax":
        # padded dims are zero columns: a rank-deficient covariance whose
        # zero diagonal the smart_cov fill repairs
        dim = 2
        thetas[:, dim:] = 0.0
    return thetas, (w / w.sum()).astype(np.float32), dim


@pytest.mark.parametrize("sel", ["silverman", "scott"])
@pytest.mark.parametrize("case", ["one_row", "heavy_row", "dim_lt_dmax"])
def test_device_fit_edge_cases_match_jax(case, sel):
    thetas, w, dim = _edge_population(case)
    jsel, tsel = SELECTORS[sel]
    jp = jax.tree.map(np.asarray, jmvn.MultivariateNormalTransition
                      .device_fit(jnp.asarray(thetas), jnp.asarray(w),
                                  dim=dim, scaling=1.0,
                                  bandwidth_selector=jsel))
    tp = MultivariateNormalTransition.device_fit(
        torch.from_numpy(thetas), torch.from_numpy(w), dim=dim, scaling=1.0,
        bandwidth_selector=tsel)
    # weighted moments: rel 1e-5 (the centred rows inherit the mean's
    # absolute error); factor, inverse and log: rel 1e-4
    for k in ("center", "weights", "thetas"):
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tp["thetas_c"].numpy(), jp["thetas_c"],
                               rtol=1e-5,
                               atol=1e-5 * np.abs(jp["center"]).max())
    for k in ("chol", "prec", "logdet", "quad"):
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the ancestor cdf K2 searches: the weights' running sum, flat on
    # the zero-weight rows
    np.testing.assert_allclose(tp["cdf"].numpy(),
                               convert.ancestor_cdf(jp["weights"]),
                               rtol=1e-6, atol=1e-7)
    assert np.all(np.diff(tp["cdf"].numpy()) >= 0)
    if dim < thetas.shape[1]:
        assert np.all(tp["chol"].numpy()[dim:] == 0)
        assert np.all(tp["prec"].numpy()[:, dim:] == 0)


@pytest.mark.parametrize("x,rung", [(1.0, 0), (-1e-11, 1), (-1e-9, 2),
                                    (-1e-6, 3), (-1.0, 4)])
def test_chol_ladder_takes_each_rung_like_jax(x, rung):
    """A covariance whose last pivot is negative by x: the ladder's rung
    (0 no jitter, 1-3 the jitter 1e-10, 1e-7, 1e-4 times the mean
    diagonal, 4 none) is the first whose factor is finite."""
    cov = np.diag(np.array([1.0, 2.0, 0.5, x], np.float32))
    cov[0, 1] = cov[1, 0] = 0.3
    jchol, jused, jbad = jutil.device_chol_guarded(jnp.asarray(cov))
    chol, used, bad = transition_util.device_chol_guarded(
        torch.from_numpy(cov))
    assert bool(bad) == bool(jbad) == (rung == 4)
    np.testing.assert_array_equal(used.numpy(), np.asarray(jused))
    np.testing.assert_allclose(chol.numpy(), np.asarray(jchol), rtol=1e-6,
                               atol=1e-7)
    tr = np.float32(np.trace(cov) / 4)
    jitter = [0.0, 1e-10, 1e-7, 1e-4, 1e-4][rung]
    assert used.numpy()[3, 3] == np.float32(x) + np.float32(
        np.float32(jitter) * tr)
