"""K7: importance-weight normalization and the weighted-quantile epsilon.

Counterpart of ``pyabc_tpu/ops/stats.py::normalize_log_weights`` and
``weighted_quantile`` as the generation step and the calibration use them
(``pyabc_tpu/inference/util.py:1774, 1871``); the CUDA kernels are in
``csrc/normalize_quantile.cu``, the quantile by weighted radix selection
(``csrc/select.cuh``). ``ops/stats.py`` calls this wrapper.
"""
from __future__ import annotations

import torch

from . import _build
from .base import Kernel
from .select import workspace


def weighted_quantile_plain(points: torch.Tensor, weights: torch.Tensor,
                            alpha: float) -> torch.Tensor:
    """Step-function weighted quantile: stable sort, cumsum, left search."""
    order = torch.argsort(points, stable=True)
    p = points[order]
    cum = torch.cumsum(weights[order], 0)
    cdf = cum / cum[-1]
    a = torch.full((1,), float(alpha), dtype=cdf.dtype, device=cdf.device)
    idx = torch.searchsorted(cdf, a, side="left").clamp(0, p.shape[0] - 1)
    return p[idx][0]


def normalize_log_weights_plain(log_w: torch.Tensor,
                                mask: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """exp-normalize masked log-weights to sum to 1; an all-masked (or all
    -inf) input gives all zeros instead of NaN."""
    if mask is not None:
        log_w = torch.where(mask, log_w, torch.full_like(log_w, -torch.inf))
    m = log_w.max()
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(log_w - safe_m)
    total = w.sum()
    return torch.where(total > 0,
                       w / torch.where(total > 0, total,
                                       torch.ones_like(total)),
                       torch.zeros_like(w))


class NormalizeQuantile(Kernel):
    name = "normalize_quantile"
    source = "pyabc_tpu_torch/csrc/normalize_quantile.cu"
    replaces = "pyabc_tpu/ops/stats.py:48"

    def normalize(self, log_w: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.on_cpu(log_w, *([] if mask is None else [mask])):
            return normalize_log_weights_plain(log_w, mask)
        n = log_w.shape[0]
        self.expect(log_w, "log_w", torch.float32, (n,))
        if mask is not None:
            self.expect(mask, "mask", torch.bool, (n,))
        out = torch.empty_like(log_w)
        err = _build.library().pyabc_normalize_log_weights(
            log_w.data_ptr(), self.ptr(mask), n, out.data_ptr(),
            _build.stream_ptr(log_w.device))
        _build.check(err, self.name)
        self.launches += 1
        return out

    def quantile(self, points: torch.Tensor, weights: torch.Tensor,
                 alpha: float) -> torch.Tensor:
        if self.on_cpu(points, weights):
            return weighted_quantile_plain(points, weights, alpha)
        n = points.shape[0]
        if n == 0:
            raise ValueError(f"{self.name}: no points")
        self.expect(points, "points", torch.float32, (n,))
        self.expect(weights, "weights", torch.float32, (n,))
        dev = points.device
        out = torch.empty((), dtype=torch.float32, device=dev)
        ws = workspace(1, 1, True, dev)
        err = _build.library().pyabc_weighted_quantile(
            points.data_ptr(), weights.data_ptr(), n, float(alpha),
            ws.data_ptr(), out.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out


normalize_quantile = NormalizeQuantile()
