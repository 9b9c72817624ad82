"""K17: GridSearchCV's cross-validated bandwidth selection over the MVN
scaling, the refit of a generation step.

Counterpart of ``pyabc_tpu/transition/grid_search.py::GridSearchCV.
device_fit`` (``:119-208``); the CUDA kernel is ``csrc/grid_search_cv.cu``.
On ``thetas (n_cap, d)``, normalized ``weights (n_cap,)`` (0 on empty
slots), the fold ids ``folds (n_cap,)`` int32 (-1: no fold) with
``n_folds`` folds and the candidate scalings ``s_1..s_C``:

- fold f fits the MVN at scaling 1 on ``where(folds != f, w, 0)`` (K8's
  fit: weights renormalized, the bandwidth from the fold's own ESS, the
  jitter ladder);
- each held-out row q of fold f scores, for every scaling,
  ``logsumexp_j(log w_j - 0.5 (dim log 2 pi + logdet_f + 2 dim log s +
  maha_qj / s^2))`` with ``maha_qj = (q - theta_j)' P_f (q - theta_j)``,
  floored at ``log(1e-300)``, and adds ``w_q * logdens`` to the scaling's
  score; a fold with fewer than 2 train rows of positive weight or no
  test row of positive weight adds nothing;
- the winner is the first maximum of the scores, and the full-data fit at
  scaling 1 is scaled by it: ``chol s``, ``prec / s^2``, ``quad / s^2``,
  ``logdet + 2 dim log s``.

The result is K8's params dict (so K2 and K3 propose and score from it),
the scores ``(C,)`` and the winner's index.

K > 1 mode (``grid_search_cv.models``, a run over several models,
``smc.py:1651-1658`` of the JAX package): model k's weights are masked to
its rows, the fold ids stay row-indexed over the whole population, and the
params are stacked as K8's K > 1 mode stacks them (``dims`` in place of
``dim``); counted in ``mode_launches["models"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable

import torch

from . import _build
from .base import Kernel
from .mvn_fit import (MAX_DIM, MAX_MODELS, SELECTORS, STACKED_KEYS,
                      mvn_fit_plain)

#: candidate scalings the kernel keeps accumulators for (per row, in
#: registers)
MAX_SCALINGS = 16
#: folds one launch takes
MAX_FOLDS = 64
#: log(1e-300) in float32, the floor of a held-out log-density
LOG_FLOOR = float(torch.tensor(math.log(1e-300), dtype=torch.float32))
LOG_2PI = math.log(2 * math.pi)
#: query-component pairs a chunk of the plain version holds
PLAIN_PAIRS = 1 << 22


def splits_of(n_cap: int) -> int:
    """Component ranges the scoring kernel splits each fold's pairs into
    (more blocks in flight at large n); their log-sum-exp states merge in
    a fixed order, so a shape always sums the same way."""
    return max(1, min(8, n_cap // 2048))


def fold_scores_plain(thetas: torch.Tensor, weights: torch.Tensor,
                      folds: torch.Tensor, *, n_folds: int, dim: int,
                      scalings, bandwidth_selector: Callable
                      ) -> torch.Tensor:
    """The scores ``(C,)`` of every scaling, summed over the folds in
    order (the JAX package's loop)."""
    dev = thetas.device
    s_arr = torch.tensor([float(s) for s in scalings], dtype=torch.float32,
                         device=dev)
    log_s = torch.log(s_arr)
    scores = torch.zeros(len(scalings), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(weights)
    for f in range(int(n_folds)):
        train_w = torch.where(folds != f, weights, zero)
        fit = mvn_fit_plain(thetas, train_w, dim=dim, scaling=1.0,
                            bandwidth_selector=bandwidth_selector)
        test = torch.nonzero(folds == f).flatten()
        q, qw = thetas[test], weights[test]
        fold_ok = ((train_w > 0).sum() >= 2) & ((qw > 0).sum() >= 1)
        log_w = torch.log(fit["weights"])
        n = thetas.shape[0]
        step = max(1, PLAIN_PAIRS // max(n, 1))
        parts = torch.zeros(len(scalings), dtype=torch.float32, device=dev)
        for q0 in range(0, q.shape[0], step):
            diff = q[q0:q0 + step, None, :] - fit["thetas"][None, :, :]
            maha = torch.einsum("qnd,de,qne->qn", diff, fit["prec"], diff)
            for i in range(len(scalings)):
                s2 = torch.exp(2.0 * log_s[i])
                log_comp = -0.5 * (dim * LOG_2PI + fit["logdet"]
                                   + 2.0 * dim * log_s[i] + maha / s2)
                logdens = torch.logsumexp(log_comp + log_w[None, :], dim=1)
                logdens = logdens.clamp_min(LOG_FLOOR)
                parts[i] += torch.sum(qw[q0:q0 + step] * logdens)
        scores = scores + torch.where(fold_ok, parts, torch.zeros_like(parts))
    return scores


def scale_fit(full: dict, s_best: torch.Tensor, dim: int) -> dict:
    """The full fit at scaling 1 scaled by the winner."""
    s2 = s_best * s_best
    return {**full, "chol": full["chol"] * s_best,
            "prec": full["prec"] / s2, "quad": full["quad"] / s2,
            "logdet": full["logdet"] + 2.0 * dim * torch.log(s_best)}


def grid_search_cv_plain(thetas: torch.Tensor, weights: torch.Tensor,
                         folds: torch.Tensor, *, n_folds: int, dim: int,
                         scalings, bandwidth_selector: Callable):
    """Plain PyTorch version -> (K8's params at the winning scaling, the
    scores ``(C,)``, the winner's index, int32)."""
    scores = fold_scores_plain(thetas, weights, folds, n_folds=n_folds,
                               dim=dim, scalings=scalings,
                               bandwidth_selector=bandwidth_selector)
    best = torch.argmax(scores).to(torch.int32)
    s_arr = torch.tensor([float(s) for s in scalings], dtype=torch.float32,
                         device=thetas.device)
    full = mvn_fit_plain(thetas, weights, dim=dim, scaling=1.0,
                         bandwidth_selector=bandwidth_selector)
    return scale_fit(full, s_arr[best.long()], dim), scores, best


def grid_search_cv_models_plain(thetas: torch.Tensor, weights: torch.Tensor,
                                m: torch.Tensor, folds: torch.Tensor, *,
                                n_folds: int, dims, scalings, selectors,
                                dims_tensor: torch.Tensor | None = None):
    """Plain PyTorch version of the K > 1 mode: one ``grid_search_cv_plain``
    per model on its masked weights, stacked -> (params, scores ``(K,
    C)``, winners ``(K,)``)."""
    fits, scores, best = [], [], []
    for k in range(len(dims)):
        w_k = torch.where(m == k, weights, torch.zeros_like(weights))
        p, s, b = grid_search_cv_plain(
            thetas, w_k, folds, n_folds=n_folds, dim=dims[k],
            scalings=scalings, bandwidth_selector=selectors[k])
        fits.append(p)
        scores.append(s)
        best.append(b)
    out = {k: torch.stack([f[k] for f in fits]).contiguous()
           for k in STACKED_KEYS}
    out["dims"] = (dims_tensor if dims_tensor is not None else
                   torch.tensor([float(x) for x in dims],
                                dtype=torch.float32, device=thetas.device))
    return out, torch.stack(scores), torch.stack(best)


class GridSearchCVKernel(Kernel):
    name = "grid_search_cv"
    source = "pyabc_tpu_torch/csrc/grid_search_cv.cu"
    replaces = "pyabc_tpu/transition/grid_search.py:119"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"models": 0}

    def _check(self, thetas, weights, folds, n_folds, scalings, K):
        n, d = thetas.shape
        C = len(scalings)
        if (d > MAX_DIM or not 0 < C <= MAX_SCALINGS
                or not 0 < n_folds <= MAX_FOLDS
                or not 0 < K <= MAX_MODELS):
            raise ValueError(
                f"{self.name}: dim {d} (cap {MAX_DIM}), {C} scalings (cap "
                f"{MAX_SCALINGS}), {n_folds} folds (cap {MAX_FOLDS}) or {K} "
                f"models (cap {MAX_MODELS}) outside the kernel's range")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (n, d))
        self.expect(weights, "weights", f32, (n,))
        self.expect(folds, "folds", torch.int32, (n,))
        return n, d, C

    def _launch(self, thetas, weights, m, folds, n_folds, dims, scalings,
                selectors, out: dict, K: int) -> tuple:
        """One launch of the entry over K models (``m`` None: one model)
        into ``out`` (K8's buffers) -> (scores (K, C), winners (K,))."""
        n, d = thetas.shape
        C = len(scalings)
        dev, f32, i32 = thetas.device, torch.float32, torch.int32
        sel = [SELECTORS.get(getattr(s, "__name__", "")) for s in selectors]
        if None in sel:
            raise NotImplementedError(
                f"{self.name}: a bandwidth rule has no kernel (scott or "
                f"silverman)")
        S = splits_of(n)
        F = int(n_folds)
        # scratch: each model's rows of positive weight grouped by fold,
        # the fold offsets with the count of positive rows, each fold fit's
        # precision, logdet and weight sum, the split log-sum-exp states,
        # the per-fold scores
        lists = torch.empty(K, n, dtype=i32, device=dev)
        offsets = torch.empty(K, F + 2, dtype=i32, device=dev)
        fold_fit = torch.empty(K, F, d * d + 2, dtype=f32, device=dev)
        parts = torch.empty(K, S, n, C, 2, dtype=f32, device=dev)
        fold_scores = torch.empty(K, F, C, dtype=f32, device=dev)
        scores = torch.empty(K, C, dtype=f32, device=dev)
        best = torch.empty(K, dtype=i32, device=dev)

        def arr(ctype, vals):
            return (ctype * len(vals))(*vals)

        c_int, c_float = ctypes.c_int, ctypes.c_float
        err = _build.library().pyabc_grid_search_cv(
            thetas.data_ptr(), weights.data_ptr(), self.ptr(m),
            folds.data_ptr(), K, n, d, F, C, S,
            arr(c_int, [int(x) for x in dims]),
            arr(c_float, [float(s) for s in scalings]),
            arr(c_int, sel),
            arr(c_float, [(4 / (x + 2)) ** (1 / (x + 4)) for x in dims]),
            arr(c_float, [-1.0 / (x + 4) for x in dims]),
            *(out[k].data_ptr() for k in STACKED_KEYS),
            lists.data_ptr(), offsets.data_ptr(), fold_fit.data_ptr(),
            parts.data_ptr(), fold_scores.data_ptr(), scores.data_ptr(),
            best.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return scores, best

    def __call__(self, thetas: torch.Tensor, weights: torch.Tensor,
                 folds: torch.Tensor, *, n_folds: int, dim: int, scalings,
                 bandwidth_selector: Callable):
        """-> (K8's params dict at the winning scaling, the scores ``(C,)``,
        the winner's index ``()`` int32)."""
        if self.on_cpu(thetas, weights, folds):
            return grid_search_cv_plain(
                thetas, weights, folds, n_folds=n_folds, dim=dim,
                scalings=scalings, bandwidth_selector=bandwidth_selector)
        n, d, _C = self._check(thetas, weights, folds, n_folds, scalings, 1)
        dev, f32 = thetas.device, torch.float32
        shapes = {"thetas": (n, d), "weights": (n,), "chol": (d, d),
                  "prec": (d, d), "center": (d,), "thetas_c": (n, d),
                  "quad": (n,), "logdet": (), "cdf": (n,)}
        out = {k: torch.empty(s, dtype=f32, device=dev)
               for k, s in shapes.items()}
        scores, best = self._launch(thetas, weights, None, folds, n_folds,
                                    [dim], scalings, [bandwidth_selector],
                                    out, 1)
        return {**out, "dim": float(dim)}, scores[0], best[0]

    def models(self, thetas: torch.Tensor, weights: torch.Tensor,
               m: torch.Tensor, folds: torch.Tensor, *, n_folds: int, dims,
               scalings, selectors,
               dims_tensor: torch.Tensor | None = None):
        """The K > 1 mode: ``dims`` and ``selectors`` (each model's
        bandwidth rule) are per-model host values, ``dims_tensor`` the
        models' dims as a float32 device tensor that the stacked params
        carry -> (stacked params, scores ``(K, C)``, winners ``(K,)``)."""
        extra = [dims_tensor] if dims_tensor is not None else []
        if self.on_cpu(thetas, weights, m, folds, *extra):
            return grid_search_cv_models_plain(
                thetas, weights, m, folds, n_folds=n_folds, dims=dims,
                scalings=scalings, selectors=selectors,
                dims_tensor=dims_tensor)
        K = len(dims)
        n, d, _C = self._check(thetas, weights, folds, n_folds, scalings, K)
        if len(selectors) != K:
            raise ValueError(f"{self.name}: {len(selectors)} bandwidth "
                             f"rules for {K} models")
        self.expect(m, "m", torch.int32, (n,))
        f32 = torch.float32
        if dims_tensor is None:
            dims_tensor = torch.tensor([float(x) for x in dims], dtype=f32,
                                       device=thetas.device)
        self.expect(dims_tensor, "dims_tensor", f32, (K,))
        dev = thetas.device
        shapes = {"thetas": (K, n, d), "weights": (K, n), "chol": (K, d, d),
                  "prec": (K, d, d), "center": (K, d),
                  "thetas_c": (K, n, d), "quad": (K, n), "logdet": (K,),
                  "cdf": (K, n)}
        out = {k: torch.empty(shapes[k], dtype=f32, device=dev)
               for k in STACKED_KEYS}
        scores, best = self._launch(thetas, weights, m, folds, n_folds, dims,
                                    scalings, selectors, out, K)
        self.mode_launches["models"] += 1
        return {**out, "dims": dims_tensor}, scores, best


grid_search_cv = GridSearchCVKernel()
