"""Carry state across from the JAX package, given as numpy arrays and plain
specs, so that both packages can be fed the same state and compared.

Nothing here imports the JAX package: the caller turns its arrays into
numpy first (``jax.tree.map(np.asarray, ...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.random_variables import RV, Distribution, LowerBoundDecorator
from .inference.context import Carry
from .kernels.local_factor import lconst_of
from .kernels.model_step import next_generation_terms
from .utils import not_ported, resolve_device

#: keys of a fitted MultivariateNormalTransition's device params
TRANSITION_KEYS = ("thetas", "weights", "chol", "prec", "center",
                   "thetas_c", "quad", "logdet")


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def ancestor_cdf(weights) -> np.ndarray:
    """The ancestor CDF that K2 searches, from a weight vector, in float32:
    cummax(where(w > 0, cumsum(w), 0))."""
    w = np.asarray(weights, np.float32)
    cum = np.cumsum(w, dtype=np.float32)
    return np.maximum.accumulate(np.where(w > 0, cum, np.float32(0)))


def transition_params(params: dict, device=None) -> dict:
    """``device_params``/``device_fit`` dict -> the port's params (float32
    tensors, contiguous; ``dim`` a Python float; the ancestor ``cdf``
    computed from the weights). ``device=None`` means the CUDA card, as
    everywhere in the port."""
    device = resolve_device(device)
    out = {k: _f32(params[k], device).contiguous() for k in TRANSITION_KEYS}
    out["cdf"] = _f32(ancestor_cdf(params["weights"]), device).contiguous()
    out["dim"] = float(np.asarray(params["dim"]))
    return out


#: keys of a fitted LocalTransition's device params
LOCAL_KEYS = ("thetas", "weights", "chols", "precs", "logdets")


def local_transition_params(params: dict, device=None) -> dict:
    """LocalTransition's ``device_params``/``device_fit`` dict -> the
    port's params: the five tensors, the ancestor ``cdf`` and the port-only
    per-component constant ``lconst`` (K13's, from the weights and
    logdets), ``dim`` a Python float."""
    device = resolve_device(device)
    out = {k: _f32(params[k], "cpu").contiguous() for k in LOCAL_KEYS}
    dim = float(np.asarray(params["dim"]))
    out["cdf"] = _f32(ancestor_cdf(params["weights"]), "cpu")
    out["lconst"] = lconst_of(out["weights"], out["logdets"], int(dim))
    return {**{k: v.contiguous().to(device) for k, v in out.items()},
            "dim": dim}


def stacked_transition_params(params_k, device=None) -> dict:
    """The JAX package's K-tuple of d_max-padded transition params
    (``pad_transition_params`` or K ``device_fit`` results) -> the port's
    stacked params (a leading model axis; ``dims (K,)`` float32 from each
    set's ``dim``)."""
    device = resolve_device(device)
    parts = [transition_params(p, "cpu") for p in params_k]
    out = {k: torch.stack([p[k] for p in parts]).contiguous().to(device)
           for k in (*TRANSITION_KEYS, "cdf")}
    out["dims"] = torch.tensor([p["dim"] for p in parts],
                               dtype=torch.float32, device=device)
    return out


def distance_weights(w, device=None) -> torch.Tensor:
    """A p-norm weight vector (``device_params`` of a PNormDistance)."""
    return _f32(np.ravel(np.asarray(w)), resolve_device(device))


def aggregated_params(distance, t=None, device=None) -> torch.Tensor:
    """A JAX ``AggregatedDistance``'s ``device_params(t)`` (``W`` and the
    sub-distances' weight vectors) -> the port's flat float32 params
    ``[W (n), w_1 (S), ..., w_n (S)]`` (K25's layout)."""
    W, subs = distance.device_params(t)
    flat = np.concatenate([np.asarray(W, np.float32).ravel(),
                           *(np.asarray(s, np.float32).ravel()
                             for s in subs)])
    return torch.tensor(flat, device=resolve_device(device))


def prior(spec) -> Distribution:
    """``[(name, "norm"|"uniform", loc, scale), ...]`` -> Distribution."""
    return Distribution.from_spec(spec)


def _rv_from_jax(rv, key: str):
    kind = type(rv).__name__
    if kind == "LowerBoundDecorator":
        if type(rv.component).__name__ != "RV":
            raise not_ported(f"prior component {key!r}: a "
                             f"LowerBoundDecorator around a "
                             f"{type(rv.component).__name__}", "16")
        return LowerBoundDecorator(_rv_from_jax(rv.component, key),
                                   rv.bound)
    if kind != "RV":
        raise not_ported(f"prior component {key!r}: a host-only {kind}",
                         "16")
    params = tuple(rv._params)
    if rv.name == "lognorm":
        s, scale = params
        params = (s, 0.0, scale)
    return RV(rv.name, *params)


def prior_from_jax(distribution) -> Distribution:
    """The port's Distribution of a JAX ``Distribution``: each ``RV`` from
    its family and canonical parameters (``rv.name``, ``rv._params``), a
    ``LowerBoundDecorator`` from its ``bound`` and ``component``; a nested
    decorator, a ``ScipyRV`` or a user ``RVBase`` raise (host-only)."""
    return Distribution(**{k: _rv_from_jax(rv, k)
                           for k, rv in distribution.rv_map.items()})


def carry(jax_carry: tuple, device=None, mpk=None) -> Carry:
    """The multigen carry slots this slice uses, from the JAX tuple
    ``(trans_params, log_model_probs, fitted, dist_w, eps, (pdf_norm,
    max_found, daly_k), stopped[, (eps_prev, stall_count)])`` with numpy
    leaves. Single model (a one-set tuple): the first transition param set
    is taken. Several models: the params are stacked, ``fitted`` and
    ``log_model_probs`` kept as ``(K,)`` vectors, and ``mpk`` (the
    ModelPerturbationKernel's matrix, required then) gives the masked
    matrix and the log model factor the next generation proposes with. The
    accept-state slots go to ``pdf_norm``, ``max_found`` and ``daly_k``
    (a noisy-ABC run's norm, largest kernel value and Daly's k; ``eps``
    is then its temperature and ``dist_w`` its kernel's variances); the
    JAX package keeps the running minimum of a complete-history acceptor
    in the first of them, so it also goes to ``hist_min``."""
    device = resolve_device(device)
    trans, logp, fitted, dist_w, eps, acc_state = jax_carry[:6]
    health = jax_carry[7] if len(jax_carry) > 7 else (np.inf, 0)
    common = dict(
        dist_w=distance_weights(dist_w, device),
        eps=_f32(eps, device),
        hist_min=_f32(acc_state[0], device),
        eps_prev=_f32(health[0], device),
        stall_count=torch.as_tensor(np.asarray(health[1], np.int32),
                                    device=device))
    if len(trans) > 1:
        if mpk is None:
            raise ValueError("a carry over several models needs the "
                             "perturbation matrix (mpk)")
        fitted_t = torch.tensor(np.asarray(fitted, bool))
        logp_t = torch.tensor(np.asarray(logp, np.float32))
        matrix, log_factor = next_generation_terms(
            torch.tensor(np.asarray(mpk, np.float32)), fitted_t, logp_t)
        return Carry(trans_params=stacked_transition_params(trans, device),
                     fitted=fitted_t.to(device),
                     log_model_probs=logp_t.to(device),
                     matrix=matrix.to(device),
                     log_model_factor=log_factor.to(device), **common)
    return Carry(
        trans_params=transition_params(trans[0], device),
        fitted=torch.as_tensor(bool(np.asarray(fitted).reshape(-1)[0]),
                               device=device),
        pdf_norm=_f32(acc_state[0], device),
        max_found=_f32(acc_state[1], device),
        daly_k=_f32(acc_state[2], device), **common)


def noise_kernel(kernel):
    """A JAX package noise kernel -> the port's, built from its constructor
    arguments (cov, var, scale, p, ret_scale, parameterization, keys), read
    by attribute: nothing of the JAX package is imported. The port's kernel
    is initialized by its ``ABCSMC`` as usual."""
    from .distance import kernel as k

    name = type(kernel).__name__
    keys = getattr(kernel, "keys", None)
    ret = getattr(kernel, "ret_scale", k.SCALE_LOG)
    if name == "NormalKernel":
        return k.NormalKernel(cov=kernel._cov_arg, ret_scale=ret, keys=keys)
    if name == "IndependentNormalKernel":
        return k.IndependentNormalKernel(var=kernel.var, keys=keys)
    if name == "IndependentLaplaceKernel":
        return k.IndependentLaplaceKernel(scale=kernel.scale, keys=keys)
    if name == "BinomialKernel":
        return k.BinomialKernel(kernel.p, ret_scale=ret, keys=keys)
    if name == "PoissonKernel":
        return k.PoissonKernel(ret_scale=ret, keys=keys)
    if name == "NegativeBinomialKernel":
        return k.NegativeBinomialKernel(
            kernel.p, ret_scale=ret, keys=keys,
            parameterization=kernel.parameterization)
    raise ValueError(f"no port of the noise kernel {name}")


def population_strategy(strategy):
    """A JAX package population strategy -> the port's, built from its
    attributes (nothing of the JAX package is imported)."""
    from . import populationstrategy as ps

    name = type(strategy).__name__
    cal = strategy.nr_calibration_particles
    if name == "ConstantPopulationSize":
        return ps.ConstantPopulationSize(strategy.nr_particles,
                                         nr_calibration_particles=cal)
    if name == "ListPopulationSize":
        return ps.ListPopulationSize(strategy.values,
                                     nr_calibration_particles=cal)
    if name == "AdaptivePopulationSize":
        return ps.AdaptivePopulationSize(
            strategy.start_nr_particles, mean_cv=strategy.mean_cv,
            max_population_size=strategy.max_population_size,
            min_population_size=strategy.min_population_size,
            n_bootstrap=strategy.n_bootstrap, nr_calibration_particles=cal)
    raise ValueError(f"no port of the population strategy {name}")


def predictor_from_jax(predictor):
    """A fitted (or unfitted) JAX predictor -> the port's, read by
    attribute (nothing of the JAX package is imported): a
    ``LinearPredictor``'s or ``LassoPredictor``'s ``alpha``, ``normalize``
    (a Lasso's ``n_iter``) and fitted ``_W``, ``_b``, ``_mu``, ``_sd`` as
    float64 numpy; an ``MLPPredictor``'s ``hidden``, ``n_steps``, ``lr``,
    ``seed``, its layers ``_params`` (a list of ``{"w", "b"}``) as float32
    numpy and ``_mu``, ``_sd``, ``_ymu``, ``_ysd`` as float64 numpy (the
    host fit's types); a ``GPPredictor``'s ``length_scale``, ``alpha``,
    ``cap``, ``seed`` and fitted ``_X``, ``_alpha_w``, ``_mu``, ``_sd``,
    ``_ymu`` (float64) and ``_ls`` (a float); a
    ``ModelSelectionPredictor``'s ``split``, ``seed`` and candidates, each
    carried across, and its winner ``chosen`` (the carried candidate at
    the same place)."""
    from .predictor import (GPPredictor, LassoPredictor, LinearPredictor,
                            MLPPredictor, ModelSelectionPredictor)

    name = type(predictor).__name__
    if name == "ModelSelectionPredictor":
        cands = [predictor_from_jax(p) for p in predictor.predictors]
        out = ModelSelectionPredictor(cands, split=predictor.split,
                                      seed=predictor.seed)
        if predictor.chosen is not None:
            out.chosen = cands[[id(p) for p in predictor.predictors].index(
                id(predictor.chosen))]
        return out
    if name == "MLPPredictor":
        out = MLPPredictor(hidden=predictor.hidden,
                           n_steps=predictor.n_steps, lr=predictor.lr,
                           seed=predictor.seed)
        if predictor._params is not None:
            out._params = [{k: np.asarray(layer[k], np.float32)
                            for k in ("w", "b")}
                           for layer in predictor._params]
        keys = ("_mu", "_sd", "_ymu", "_ysd")
    elif name == "GPPredictor":
        out = GPPredictor(length_scale=predictor.length_scale,
                          alpha=predictor.alpha, cap=predictor.cap,
                          seed=predictor.seed)
        out._ls = None if predictor._ls is None else float(predictor._ls)
        keys = ("_X", "_alpha_w", "_mu", "_sd", "_ymu")
    elif name == "LassoPredictor":
        out = LassoPredictor(alpha=predictor.alpha, n_iter=predictor.n_iter,
                             normalize=predictor.normalize)
        keys = ("_W", "_b", "_mu", "_sd")
    elif name == "LinearPredictor":
        out = LinearPredictor(alpha=predictor.alpha,
                              normalize=predictor.normalize)
        keys = ("_W", "_b", "_mu", "_sd")
    else:
        raise not_ported(f"carrying a {name} across", "14")
    for key in keys:
        value = getattr(predictor, key)
        setattr(out, key,
                None if value is None else np.asarray(value, np.float64))
    return out


def sumstat_from_jax(sumstat):
    """A JAX ``PredictorSumstat`` -> the port's, with its predictor carried
    across (``predictor_from_jax``) and its ``_out_dim`` and
    ``_last_fit_t``: its host ``predict`` and ``device_params`` serve as
    the JAX one's. ``ABCSMC`` refuses a fitted statistic before launch
    (ROADMAP queue A, item 14). A JAX ``IdentitySumstat`` -> the port's
    with the same functions (they must take torch tensors on the card, as
    the JAX package's take ``jnp`` arrays)."""
    from .sumstat import IdentitySumstat, PredictorSumstat

    if type(sumstat).__name__ == "IdentitySumstat":
        return IdentitySumstat(trafos=sumstat.trafos)
    out = PredictorSumstat(predictor_from_jax(sumstat.predictor),
                           normalize_labels=sumstat.normalize_labels,
                           fit_every=sumstat.fit_every,
                           min_samples=sumstat.min_samples)
    out._out_dim, out._last_fit_t = sumstat._out_dim, sumstat._last_fit_t
    return out
