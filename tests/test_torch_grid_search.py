"""Port parity: K17 (GridSearchCV's cross-validated bandwidth selection).

The same numpy inputs go through the JAX package's
``GridSearchCV.device_fit`` and the port's K17 (plain PyTorch on the CPU).
The JAX function keeps its scores to itself; the tests read them from its
``argmax`` call. Tolerances: the scores within 1e-4 relative (float32
log-sum-exps summed in another order); the same winner wherever the two
best scores differ by more than 1e-4 relative; the returned params within
K8's tolerances (rtol 1e-4, atol 1e-5). The gates: every configuration the
JAX fused gate sends to its host loop raises ``not_ported`` in the port,
with the JAX gate's reason.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import pyabc_tpu as jpt  # noqa: E402
from pyabc_tpu.transition import grid_search as jgs  # noqa: E402
from pyabc_tpu.transition import util as jutil  # noqa: E402
import pyabc_tpu_torch as tpt  # noqa: E402
from pyabc_tpu_torch.kernels import grid_search_cv  # noqa: E402
from pyabc_tpu_torch.kernels.mvn_fit import STACKED_KEYS  # noqa: E402
from pyabc_tpu_torch.models import gaussian  # noqa: E402
from pyabc_tpu_torch.transition import (fold_ids,  # noqa: E402
                                        silverman_rule_of_thumb)

torch.set_num_threads(1)

PARAM_KEYS = ("chol", "prec", "logdet", "quad", "center", "thetas_c",
              "weights", "thetas")


class _JnpSpy:
    """``jax.numpy`` with ``argmax`` recording its input: the JAX
    function's scores."""

    def __init__(self):
        self.scores = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argmax(self, x, *args, **kwargs):
        self.scores.append(np.asarray(x))
        return jnp.argmax(x, *args, **kwargs)


def _jax_fit(monkeypatch, X, w, dim, scalings, cv, **kw):
    spy = _JnpSpy()
    monkeypatch.setattr(jgs, "jnp", spy)
    if kw.get("folds") is not None:
        kw["folds"] = jnp.asarray(kw["folds"])
    out = jgs.GridSearchCV.device_fit(
        jnp.asarray(X), jnp.asarray(w), dim=dim, scalings=tuple(scalings),
        cv=cv, bandwidth_selector=jutil.silverman_rule_of_thumb, **kw)
    monkeypatch.undo()
    return jax.tree.map(np.asarray, out), spy.scores[-1]


def _port_fit(X, w, folds, n_folds, dim, scalings):
    return grid_search_cv(torch.from_numpy(X), torch.from_numpy(w),
                          torch.from_numpy(folds), n_folds=n_folds, dim=dim,
                          scalings=scalings,
                          bandwidth_selector=silverman_rule_of_thumb)


def _clear_winner(scores) -> bool:
    top = np.sort(np.asarray(scores, np.float64))[::-1]
    return len(top) < 2 or top[0] - top[1] > 1e-4 * abs(top[0])


def _hold(jp, js, tp, ts, tb):
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-4)
    if _clear_winner(js):
        assert int(tb) == int(np.argmax(js))
    if int(tb) == int(np.argmax(js)):
        for k in PARAM_KEYS:
            np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _population(seed, n_cap, n, d, loc=1.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(loc, 0.5, size=(n_cap, d)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, n_cap).astype(np.float32)
    X[n:] = 0.0
    w[n:] = 0.0
    return X, (w / w.sum()).astype(np.float32)


def test_jax_suite_case_and_its_host_winner(monkeypatch):
    """The JAX suite's case (``test_fused.py:685-720``: n 60, d 2, scalings
    0.25, 1, 4, cv 3), and its host-winner rule: the port's params are an
    MVN fit at the host GridSearchCV's best scaling (rtol 5e-3)."""
    rng = np.random.default_rng(5)
    n, dim = 60, 2
    X = np.stack([rng.normal(0, 1, n), rng.normal(1, 0.4, n)],
                 1).astype(np.float32)
    w = rng.uniform(0.5, 1.0, n)
    w = (w / w.sum()).astype(np.float32)
    scalings = (0.25, 1.0, 4.0)
    jp, js = _jax_fit(monkeypatch, X, w, dim, scalings, 3)
    tp, ts, tb = _port_fit(X, w, fold_ids(n, 3, n), 3, dim, scalings)
    _hold(jp, js, tp, ts, tb)
    host = jpt.GridSearchCV(jpt.MultivariateNormalTransition(),
                            {"scaling": list(scalings)}, cv=3)
    df = pd.DataFrame(X.astype(np.float64), columns=["a", "b"])
    host.fit(df, w.astype(np.float64))
    ref = jpt.MultivariateNormalTransition(
        scaling=host.best_params_["scaling"])
    ref.fit(df, w.astype(np.float64))
    np.testing.assert_allclose(tp["chol"].numpy(), ref._chol, rtol=5e-3,
                               atol=5e-3)
    np.testing.assert_allclose(float(tp["logdet"]), ref._logdet, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_padded_reservoir_matches_jax(monkeypatch, d):
    """A constant n of 90 in a reservoir of 128 (rows past n in no fold),
    d 1, 2 and 4, five scalings, cv 5."""
    X, w = _population(10 + d, 128, 90, d)
    scalings = (0.25, 0.5, 1.0, 2.0, 4.0)
    jp, js = _jax_fit(monkeypatch, X, w, d, scalings, 5, n=90)
    tp, ts, tb = _port_fit(X, w, fold_ids(90, 5, 128), 5, d, scalings)
    _hold(jp, js, tp, ts, tb)


@pytest.mark.parametrize("n_rows", [4, 150])
def test_fold_table_matches_jax(monkeypatch, n_rows):
    """A list generation's fold table (``cv`` folds; at n 4 with cv 5 one
    fold id is missing and its fold adds nothing)."""
    X, w = _population(20 + n_rows, 256, n_rows, 2)
    table = fold_ids(n_rows, 5, 256)
    scalings = (0.25, 1.0, 2.25)
    jp, js = _jax_fit(monkeypatch, X, w, 2, scalings, 5, folds=table)
    tp, ts, tb = _port_fit(X, w, table, 5, 2, scalings)
    _hold(jp, js, tp, ts, tb)


def test_fold_without_a_weighted_test_row_is_skipped(monkeypatch):
    """A fold whose test rows all have weight 0 adds nothing (fold_ok)."""
    X, w = _population(31, 64, 60, 2)
    folds = fold_ids(60, 3, 64)
    w = np.where(folds == 1, 0.0, w).astype(np.float32)
    w = (w / w.sum()).astype(np.float32)
    scalings = (0.5, 1.0, 2.0)
    jp, js = _jax_fit(monkeypatch, X, w, 2, scalings, 3, n=60)
    tp, ts, tb = _port_fit(X, w, folds, 3, 2, scalings)
    _hold(jp, js, tp, ts, tb)
    # the same scores as folds 0 and 2 alone
    only = np.where(folds == 1, -1, folds).astype(np.int32)
    _tp, ts2, _tb = _port_fit(X, w, only, 3, 2, scalings)
    np.testing.assert_array_equal(ts.numpy(), ts2.numpy())


def test_models_mode_matches_jax_per_model(monkeypatch):
    """K = 2 over one reservoir (model 0 of dim 1 zero-padded to 2): each
    model's JAX fit on its masked weights, the folds row-indexed over the
    whole population."""
    rng = np.random.default_rng(41)
    n_cap, n = 128, 110
    X, w = _population(41, n_cap, n, 2)
    m = rng.integers(0, 2, n_cap).astype(np.int32)
    X[m == 0, 1] = 0.0
    folds = fold_ids(n, 4, n_cap)
    scalings = (0.5, 1.0, 2.0)
    dims = [1, 2]
    tp, ts, tb = grid_search_cv.models(
        torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(m),
        torch.from_numpy(folds), n_folds=4, dims=dims, scalings=scalings,
        selectors=[silverman_rule_of_thumb] * 2)
    assert tp["dims"].tolist() == [1.0, 2.0]
    for k in range(2):
        w_k = np.where(m == k, w, 0.0).astype(np.float32)
        jp, js = _jax_fit(monkeypatch, X, w_k, dims[k], scalings, 4, n=n)
        _hold(jp, js, {key: tp[key][k] for key in STACKED_KEYS}, ts[k],
              tb[k])


def test_port_transition_device_fit_signature(monkeypatch):
    """``GridSearchCV.device_fit`` takes the JAX package's arguments (``n``
    or ``folds``) and returns K8's params at the winner."""
    X, w = _population(51, 64, 50, 2)
    scalings = (0.5, 1.0, 2.0)
    jp, _js = _jax_fit(monkeypatch, X, w, 2, scalings, 3, n=50)
    tp = tpt.GridSearchCV.device_fit(
        torch.from_numpy(X), torch.from_numpy(w), dim=2, scalings=scalings,
        cv=3, bandwidth_selector=silverman_rule_of_thumb, n=50)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert set(tp) >= set(STACKED_KEYS) | {"dim"}


def _grid(*scalings, cv=5, estimator=None):
    return tpt.GridSearchCV(estimator or tpt.MultivariateNormalTransition(),
                            {"scaling": list(scalings)}, cv=cv)


def _jgrid(*scalings, cv=5, estimator=None):
    return jpt.GridSearchCV(estimator or jpt.MultivariateNormalTransition(),
                            {"scaling": list(scalings)}, cv=cv)


def _jax_gauss():
    @jpt.JaxModel.from_function(["theta"], name="gauss")
    def model(key, theta):
        return {"x": theta[0] + 0.5 * jax.random.normal(key)}

    return model


@pytest.mark.parametrize("what", [
    "nonpositive_scaling", "cv_one", "cv_above_n", "adaptive", "list_below_cv",
    "mixed_models", "other_grid_key", "local_estimator"])
def test_what_the_jax_fused_gate_refuses_raises(what):
    """Each configuration the JAX fused gate (``smc.py:1651-1695``) sends
    to its host loop: the JAX package is not fused-capable on it, and the
    port raises ``not_ported`` citing item 16 (``test_fused.py``'s
    ``test_gridsearch_nonpositive_scaling_falls_back`` and
    ``test_gridsearch_degenerate_cv_falls_back`` mirrored)."""
    t_model = gaussian.make_mean_only_model()
    t_prior = gaussian.mean_only_prior()
    j_prior = jpt.Distribution(theta=jpt.RV("norm", 0.0, 1.0))
    t_kw = dict(transitions=_grid(0.5, 2.0))
    j_kw = dict(transitions=_jgrid(0.5, 2.0))
    t_models, j_models = t_model, _jax_gauss()
    t_priors, j_priors = t_prior, j_prior
    if what == "nonpositive_scaling":
        t_kw["transitions"], j_kw["transitions"] = (_grid(0.0, 1.0, 2.0),
                                                    _jgrid(0.0, 1.0, 2.0))
        match = "positive scalings"
    elif what in ("cv_one", "cv_above_n"):
        cv = 1 if what == "cv_one" else 10_000
        t_kw["transitions"] = _grid(0.5, 2.0, cv=cv)
        j_kw["transitions"] = _jgrid(0.5, 2.0, cv=cv)
        match = "outside \\[2, n\\(0\\)\\]"
    elif what == "adaptive":
        t_kw["population_size"] = tpt.AdaptivePopulationSize(
            100, max_population_size=400)
        j_kw["population_size"] = jpt.AdaptivePopulationSize(
            100, max_population_size=400)
        match = "AdaptivePopulationSize"
    elif what == "list_below_cv":
        t_kw["population_size"] = tpt.ListPopulationSize([100, 4])
        j_kw["population_size"] = jpt.ListPopulationSize([100, 4])
        match = "below cv"
    elif what == "mixed_models":
        t_models, j_models = [t_model, t_model], [j_models, _jax_gauss()]
        t_priors, j_priors = [t_prior, t_prior], [j_prior, j_prior]
        t_kw["transitions"] = [_grid(0.5, 2.0),
                               tpt.MultivariateNormalTransition()]
        j_kw["transitions"] = [_jgrid(0.5, 2.0),
                               jpt.MultivariateNormalTransition()]
        match = "not one GridSearchCV configuration"
    elif what == "other_grid_key":
        t_kw["transitions"] = tpt.GridSearchCV(
            tpt.MultivariateNormalTransition(), {"bandwidth": [0.5, 1.0]})
        j_kw["transitions"] = jpt.GridSearchCV(
            jpt.MultivariateNormalTransition(), {"bandwidth": [0.5, 1.0]})
        match = "positive scalings"
    else:
        t_kw["transitions"] = _grid(0.5, 2.0,
                                    estimator=tpt.LocalTransition())
        j_kw["transitions"] = _jgrid(0.5, 2.0,
                                     estimator=jpt.LocalTransition())
        match = "LocalTransition estimator"
    j_kw.setdefault("population_size", 100)
    jabc = jpt.ABCSMC(j_models, j_priors, jpt.PNormDistance(p=2),
                      eps=jpt.MedianEpsilon(), **j_kw)
    assert not jabc._fused_chunk_capable()
    t_kw.setdefault("population_size", 100)
    with pytest.raises(NotImplementedError, match=f"{match}.*item 16"):
        tpt.ABCSMC(t_models, t_priors, tpt.PNormDistance(p=2),
                   eps=tpt.MedianEpsilon(), device="cpu", **t_kw)


def test_stochastic_acceptor_refused_as_jax_refuses_it():
    """The JAX package's fused noisy ABC admits the MVN transition and
    LocalTransition only; the port raises citing item 11."""
    model = jpt.JaxModel.from_function(["theta"], name="det")(
        lambda key, theta: {"x": theta[0]})
    jabc = jpt.ABCSMC(model, jpt.Distribution(theta=jpt.RV("norm", 0, 1)),
                      jpt.IndependentNormalKernel(var=[0.1]),
                      eps=jpt.Temperature(),
                      acceptor=jpt.StochasticAcceptor(),
                      transitions=_jgrid(0.5, 2.0))
    assert not jabc._fused_chunk_capable()
    with pytest.raises(NotImplementedError,
                       match="StochasticAcceptor.*item 11"):
        tpt.ABCSMC(gaussian.make_mean_only_model(),
                   gaussian.mean_only_prior(),
                   tpt.IndependentNormalKernel(var=[0.1]),
                   eps=tpt.Temperature(), acceptor=tpt.StochasticAcceptor(),
                   transitions=_grid(0.5, 2.0), device="cpu")


def test_grid_beyond_the_kernels_caps_raises():
    """More scalings than K17 keeps accumulators for: item 12."""
    with pytest.raises(NotImplementedError, match="17 scalings.*item 12"):
        tpt.ABCSMC(gaussian.make_mean_only_model(),
                   gaussian.mean_only_prior(), tpt.PNormDistance(p=2),
                   transitions=_grid(*np.linspace(0.1, 4.0, 17)),
                   device="cpu")
