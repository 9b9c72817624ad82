"""K26: the per-model step between two generations of a run over several
models.

Counterpart of the model terms of ``pyabc_tpu/inference/util.py``'s fused
generation step: the model probabilities, counts and fitted mask of the
new population (``util.py:1879-1886, 1936-1947, 1998-2001``) and, for the
next generation, the perturbation matrix masked to the fitted models and
row-renormalized, with the log model factor (``util.py:1640-1652``). The
CUDA kernel is ``csrc/model_step.cu``: one block, every value read from
and written to device memory, so the next generation's K2 and K5 take
them with no host read. The model-perturbation draw itself is part of K2.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel

#: models the kernel's accumulators hold
MAX_MODELS = 8


def next_generation_terms(mpk: torch.Tensor, fitted: torch.Tensor,
                          log_model_probs: torch.Tensor):
    """The masked, row-renormalized matrix and the log model factor the
    next generation proposes with -> (matrix, log_model_factor)."""
    matrix = mpk * fitted[None, :].to(mpk.dtype)
    rows = matrix.sum(dim=1, keepdim=True)
    matrix = torch.where(rows > 0, matrix / torch.where(
        rows > 0, rows, torch.ones_like(rows)), torch.zeros_like(matrix))
    factor = torch.exp(log_model_probs) @ matrix
    log_factor = torch.where(factor > 0,
                             torch.log(factor.clamp_min(1e-38)),
                             torch.full_like(factor, -math.inf))
    return matrix.contiguous(), log_factor


def model_step_plain(m: torch.Tensor, w_norm: torch.Tensor,
                     k_mask: torch.Tensor, fitted: torch.Tensor,
                     mpk: torch.Tensor) -> dict:
    """Plain PyTorch version -> dict of ``model_probs``,
    ``log_model_probs``, ``counts`` (int32), ``fitted`` (bool), ``matrix``
    and ``log_model_factor``."""
    K = mpk.shape[0]
    mine = [(m == k) & k_mask for k in range(K)]
    probs = torch.stack([torch.where(s, w_norm, torch.zeros_like(w_norm))
                         .sum() for s in mine])
    counts = torch.stack([s.sum() for s in mine]).to(torch.int32)
    fitted_next = (counts > 0) | (fitted & (counts > 0))
    log_probs = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)),
                            torch.full_like(probs, -math.inf))
    matrix, log_factor = next_generation_terms(mpk, fitted_next, log_probs)
    return {"model_probs": probs, "log_model_probs": log_probs,
            "counts": counts, "fitted": fitted_next, "matrix": matrix,
            "log_model_factor": log_factor}


class ModelStep(Kernel):
    name = "model_step"
    source = "pyabc_tpu_torch/csrc/model_step.cu"
    replaces = "pyabc_tpu/inference/util.py:1640"

    def __call__(self, m: torch.Tensor, w_norm: torch.Tensor,
                 k_mask: torch.Tensor, fitted: torch.Tensor,
                 mpk: torch.Tensor) -> dict:
        if self.on_cpu(m, w_norm, k_mask, fitted, mpk):
            return model_step_plain(m, w_norm, k_mask, fitted, mpk)
        n = m.shape[0]
        K = mpk.shape[0]
        if not 0 < K <= MAX_MODELS:
            raise ValueError(f"{self.name}: {K} models, the kernel takes "
                             f"1 to {MAX_MODELS}")
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.expect(m, "m", i32, (n,))
        self.expect(w_norm, "w_norm", f32, (n,))
        self.expect(k_mask, "k_mask", b8, (n,))
        self.expect(fitted, "fitted", b8, (K,))
        self.expect(mpk, "mpk", f32, (K, K))
        dev = m.device
        out = {"model_probs": torch.empty(K, dtype=f32, device=dev),
               "log_model_probs": torch.empty(K, dtype=f32, device=dev),
               "counts": torch.empty(K, dtype=i32, device=dev),
               "fitted": torch.empty(K, dtype=b8, device=dev),
               "matrix": torch.empty(K, K, dtype=f32, device=dev),
               "log_model_factor": torch.empty(K, dtype=f32, device=dev)}
        err = _build.library().pyabc_model_step(
            n, K, m.data_ptr(), w_norm.data_ptr(), k_mask.data_ptr(),
            fitted.data_ptr(), mpk.data_ptr(),
            *(v.data_ptr() for v in out.values()), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out


model_step = ModelStep()
