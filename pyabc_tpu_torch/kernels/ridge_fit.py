"""K23 fit (the linear plan): the boundary refit of a learned summary
statistic.

Counterpart of ``pyabc_tpu/ops/fit.py::ridge_fit`` behind
``keep_if_finite``, as ``inference/util.py:1777-1811`` runs it at a
chunk's last active generation; the CUDA kernel is ``csrc/ridge_fit.cu``.

``ridge_fit(x, y, w, counters, old, alpha=, need=)``: ``x`` the
reservoir's raw statistics ``(n_cap, S)``, ``y`` its thetas ``(n_cap,
C')``, ``w`` the weights (``exp`` of the normalized log weights, 0 off the
kept rows), ``counters`` the generation's round counters in device memory
and ``old`` the parameters in effect -> ``(params, flags)``: the new
``{"W", "b", "mu", "sd"}`` and int32 ``flags = [ok, fit]``. The fit runs
when the generation completed (``n_acc >= min(n_target, n_cap)``) and its
kept rows ``min(n_acc, n_target)`` reach ``need``; else, or when the fit is
not finite (``ok`` 0), the old parameters come back. All of it is decided
on the device: the host reads nothing. Always standardized, whatever the
predictor's ``normalize`` (the JAX package's kernel fit has no such
switch).
"""
from __future__ import annotations

import torch

from ..ops.fit import LINEAR_KEYS, keep_if_finite
from ..ops.fit import ridge_fit as fit_rows
from ..utils import not_ported
from . import _build
from .base import Kernel

#: the counters' slots the decision reads (``inference/context.py``)
N_ACC, N_TARGET = 0, 4
#: the widest fit: the float64 factorization of (S, S + C') in one block's
#: shared memory (the H100's 227 KB less 1 KB for the block's static
#: variables)
MAX_C = 32
SMEM_BYTES = 231424
#: rows a block of the column passes and of the Gram pass sums (the
#: kernel's kRows and kGramRows: they size the float64 scratch)
ROWS, GRAM_ROWS = 256, 1024


def fits_in_block(S: int, C: int) -> bool:
    """True when the (S, S + C') float64 system and a pivot column fit one
    block."""
    return 0 < C <= MAX_C and 8 * S * (S + C + 1) <= SMEM_BYTES


def ridge_fit_plain(x, y, w, counters, old: dict, *, alpha: float,
                    need: int):
    """Plain PyTorch version -> (params, flags)."""
    n_cap = x.shape[0]
    n_acc, n_tgt = counters[N_ACC], counters[N_TARGET]
    n_keep = torch.minimum(n_acc, n_tgt)
    mask = torch.arange(n_cap, device=x.device) < n_keep
    fit = (n_acc >= torch.clamp(n_tgt, max=n_cap)) & (n_keep >= need)
    new, ok = keep_if_finite(fit_rows(x, y, w, mask, alpha), old)
    params = {k: torch.where(fit, new[k], old[k]) for k in LINEAR_KEYS}
    ok = torch.where(fit, ok, torch.ones_like(ok))
    return params, torch.stack([ok, fit]).to(torch.int32)


class RidgeFit(Kernel):
    name = "ridge_fit"
    source = "pyabc_tpu_torch/csrc/ridge_fit.cu"
    replaces = "pyabc_tpu/ops/fit.py:69"

    def __call__(self, x, y, w, counters, old: dict, *, alpha: float,
                 need: int):
        olds = [old[k] for k in LINEAR_KEYS]
        if self.on_cpu(x, y, w, counters, *olds):
            return ridge_fit_plain(x, y, w, counters, old, alpha=alpha,
                                   need=need)
        n_cap, S = x.shape
        C = y.shape[1]
        if not fits_in_block(S, C):
            raise not_ported(
                f"the in-kernel linear fit at S {S}, C' {C} (one block "
                f"factors the (S, S + C') float64 system: at most "
                f"{MAX_C} outputs and 8 S (S + C' + 1) <= {SMEM_BYTES} "
                f"bytes)",
                "14")
        f32 = torch.float32
        self.expect(x, "x", f32, (n_cap, S))
        self.expect(y, "y", f32, (n_cap, C))
        self.expect(w, "w", f32, (n_cap,))
        self.expect(counters, "counters", torch.int32, (5,))
        for k, shape in (("W", (S, C)), ("b", (C,)), ("mu", (S,)),
                         ("sd", (S,))):
            self.expect(old[k], k, f32, shape)
        if not alpha > 0:
            raise ValueError(f"{self.name}: alpha must be > 0 (the "
                             f"Cholesky factorization needs A SPD)")
        dev = x.device
        f64 = torch.float64
        part1 = torch.empty(-(-n_cap // ROWS) * (S + 1 + C), dtype=f64,
                            device=dev)
        part3 = torch.empty(-(-n_cap // GRAM_ROWS) * S * (S + C), dtype=f64,
                            device=dev)
        ab = torch.empty(S * (S + C) + 2 + C, dtype=f64, device=dev)
        out = {k: torch.empty_like(old[k]) for k in LINEAR_KEYS}
        flags = torch.empty(2, dtype=torch.int32, device=dev)
        err = _build.library().pyabc_ridge_fit(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), n_cap, S, C,
            counters.data_ptr(), int(need), float(alpha),
            *(t.data_ptr() for t in olds),
            *(out[k].data_ptr() for k in LINEAR_KEYS), flags.data_ptr(),
            part1.data_ptr(), part3.data_ptr(), ab.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out, flags


ridge_fit = RidgeFit()
