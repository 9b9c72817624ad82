"""Fits of learned summary statistics, plain PyTorch
(``pyabc_tpu/ops/fit.py`` counterpart, the linear plan).

The Fearnhead-Prangle transform s(x) = E[theta | x] is learned by
regressing accepted thetas on raw summary statistics. These are the
functions the JAX package traces into its multigen kernel: the weighted
ridge fit of ``LinearPredictor`` on masked reservoir rows
(:func:`ridge_fit`), the blown-fit guard (:func:`keep_if_finite`) and
the operands of the transformed-space prefix bound of segmented early
reject (:func:`linear_bound_prepare`; the bound's fold and test are K18's
plain ``lin_bound_fold`` and ``lin_exceeds``). On the card the
port runs them as kernels: K23's fit (``kernels/ridge_fit.py``), K23's
transform (``kernels/linear_sumstat.py``) and K18's transformed mode
(``kernels/linear_bound.py``, ``kernels/segment_round.py``); the kernels'
plain versions call these.

Declared difference: the normal equations are formed and solved in
float64 (the JAX package: float32 and LU). The Gram of S = 128 correlated
statistics has a condition number of 1e4 and more, where a float32 solve
loses all but three digits; in float64 the fit is the same on the card, on
the CPU and in any summation order, and within the JAX suite's 2e-4 of the
JAX package's float32 fit.

The MLP plan (``mlp_fit_steps``) is not ported yet (ROADMAP queue A, item
14).
"""
from __future__ import annotations

import numpy as np
import torch

#: floor below which a standardization scale counts as constant
#: (``predictor._standardize_fit``: sd <= 1e-12 -> 1.0)
SD_FLOOR = 1e-12

#: relative eigenvalue threshold under which a direction of the
#: remaining-segments Gram counts as unreachable (numerically null)
NULL_EIG_RTOL = 1e-6

#: the keys of a linear transform's parameters, in the packed order
LINEAR_KEYS = ("W", "b", "mu", "sd")


def masked_standardize(x: torch.Tensor, mask: torch.Tensor):
    """Per-column (mu, sd) of the masked rows of ``x`` (n, S): the biased
    /n standard deviation with the sd floor, two passes (never E[x^2] -
    mu^2), summed in float64 -> ((S,), (S,)) float32."""
    m = mask.to(torch.float64)
    n = torch.clamp(m.sum(), min=1.0)
    xd = x.to(torch.float64)
    mu = (xd * m[:, None]).sum(0) / n
    var = (((xd - mu.to(torch.float32).to(torch.float64)) ** 2)
           * m[:, None]).sum(0) / n
    sd = torch.sqrt(var).to(torch.float32)
    sd = torch.where(sd > SD_FLOOR, sd, torch.ones_like(sd))
    return mu.to(torch.float32), sd


def ridge_fit(x, y, w, mask, alpha: float) -> dict:
    """Weighted ridge fit on masked rows (``LinearPredictor.fit``'s math):
    weights renormalized to sum n, inputs standardized by the masked (mu,
    sd), ``W = (Xs' diag(w) Xs + alpha I)^-1 Xs' diag(w) (y - ym)``, ``b =
    ym`` the weighted target mean. Rows outside ``mask`` contribute
    nothing. ``x`` (n, S), ``y`` (n, d), ``w`` (n,) nonnegative, ``mask``
    (n,) bool -> ``{"W": (S, d), "b": (d,), "mu": (S,), "sd": (S,)}``
    float32 (the standardized rows in float32, as the JAX package forms
    them; the normal equations and the solve in float64)."""
    x = x.to(torch.float32)
    S = x.shape[1]
    m = mask.to(torch.float32)
    n = torch.clamp(mask.to(torch.float64).sum(), min=1.0)
    mu, sd = masked_standardize(x, mask)
    xs = (((x - mu) / sd) * m[:, None]).to(torch.float64)
    wd = torch.clamp(w.to(torch.float64), min=0.0) * mask.to(torch.float64)
    wd = wd * n / torch.clamp(wd.sum(), min=1e-30)
    yd = y.to(torch.float64)
    A = xs.T @ (xs * wd[:, None]) + alpha * torch.eye(
        S, dtype=torch.float64, device=x.device)
    ym = (wd @ yd) / n
    B = xs.T @ (wd[:, None] * ((yd - ym) * mask.to(torch.float64)[:, None]))
    W = torch.linalg.solve(A, B)
    return {"W": W.to(torch.float32), "b": ym.to(torch.float32), "mu": mu,
            "sd": sd}


def keep_if_finite(new: dict, old: dict):
    """``(params, ok)``: ``new`` when every tensor of it is finite, else
    ``old``; ``ok`` a 0-dim bool tensor (no host read)."""
    ok = None
    for k in LINEAR_KEYS:
        f = torch.isfinite(new[k]).all()
        ok = f if ok is None else ok & f
    return {k: torch.where(ok, new[k], old[k]) for k in LINEAR_KEYS}, ok


def linear_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``LinearPredictor.device_predict`` over rows: ((x - mu) / sd) @ W +
    b; (n, S) -> (n, C') or (S,) -> (C',)."""
    xs = (x - params["mu"]) / params["sd"]
    return xs @ params["W"] + params["b"]


def bound_rows(w: torch.Tensor, params: dict) -> torch.Tensor:
    """``At[c, :] = (W[c, :] / sd[c]) * w``: the weighted transformed
    difference is ``(x - x0)^T At`` (the shift cancels)."""
    return (params["W"] / params["sd"][:, None]) * w[None, :]


def null_projector(G: torch.Tensor) -> torch.Tensor:
    """The projector onto the numerically null eigenspace of a symmetric
    ``G``: eigenvalues <= NULL_EIG_RTOL max(lambda_max, 1e-30) count as
    null."""
    lam, Q = torch.linalg.eigh(G)
    lam_max = torch.clamp(lam[-1], min=1e-30)
    null = (lam <= NULL_EIG_RTOL * lam_max).to(G.dtype)
    return (Q * null[None, :]) @ Q.T


def linear_bound_prepare(w: torch.Tensor, params: dict, imap) -> dict:
    """The per-generation operands of the transformed-space prefix bound
    (``pyabc_tpu/ops/fit.py::linear_bound_prepare``; the math is there):
    ``At`` (S, C') and the (n_seg + 1, C', C') projectors onto the null
    spaces of the suffix Grams ``G_j = At[imap[j:]]^T At[imap[j:]]``
    (``G_{n_seg} = 0``: the identity). The Grams and their eigenvectors in
    float64, the projectors returned in float32."""
    At = bound_rows(w, params)
    imap = (imap.cpu().numpy() if isinstance(imap, torch.Tensor)
            else np.asarray(imap))
    n_seg, C = imap.shape[0], At.shape[1]
    Ad = At.to(torch.float64)
    projs = []
    for j in range(n_seg + 1):
        cols = imap[j:].reshape(-1)
        if cols.size:
            rows = Ad[torch.as_tensor(cols, dtype=torch.int64,
                                      device=At.device)]
            G = rows.T @ rows
        else:
            G = torch.zeros(C, C, dtype=torch.float64, device=At.device)
        projs.append(null_projector(G))
    return {"At": At, "proj": torch.stack(projs).to(torch.float32)}
