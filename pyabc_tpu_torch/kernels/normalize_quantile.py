"""K7: importance-weight normalization and the weighted-quantile epsilon.

Counterpart of ``pyabc_tpu/ops/stats.py::normalize_log_weights`` and
``weighted_quantile`` as the generation step and the calibration use them
(``pyabc_tpu/inference/util.py:1774, 1866-1872``); the CUDA kernels are in
``csrc/normalize_quantile.cu``. ``quantile_epsilon`` is the generation
step's whole epsilon in one launch: the kept rows' (weighted)
alpha-quantile of the distances, masked rows taken as ``+inf`` of weight
0, times the multiplier. ``ops/stats.py`` calls this wrapper.

``mode_launches`` counts each launch twice: by its entry, ``normalize``
or ``epsilon`` (the quantile entries), and by the mode its size takes,
``block`` (one block, n <= 16384), ``cluster`` (a thread-block cluster of 8
blocks, n <= 131072) or ``passes`` (the three-sweep normalization and
``select.cuh``'s four-pass selection above).
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel
from .select import BINS, STATE_BYTES

#: the largest n of the block mode and of the cluster mode
BLOCK_ROWS = 16384
CLUSTER_ROWS = 8 * BLOCK_ROWS


def mode_of(n: int) -> str:
    """The mode a launch over n rows takes."""
    return ("block" if n <= BLOCK_ROWS else
            "cluster" if n <= CLUSTER_ROWS else "passes")


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


def quantile_epsilon_plain(d: torch.Tensor, k_mask: torch.Tensor,
                           w_norm: torch.Tensor | None, weighted: bool,
                           alpha: float, multiplier: float) -> torch.Tensor:
    """The next epsilon: the kept rows' (weighted) alpha-quantile of ``d``
    (a masked row is ``+inf`` of weight 0; unweighted, the mask as float)
    times ``multiplier``."""
    pts = torch.where(k_mask, d, torch.full_like(d, math.inf))
    wts = (torch.where(k_mask, w_norm, torch.zeros_like(w_norm)) if weighted
           else k_mask.to(torch.float32))
    return weighted_quantile_plain(pts, wts, alpha) * multiplier


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

    def __init__(self):
        super().__init__()
        self.mode_launches = {"normalize": 0, "epsilon": 0, "block": 0,
                              "cluster": 0, "passes": 0}

    def _count(self, entry: str, n: int) -> None:
        self.launches += 1
        self.mode_launches[entry] += 1
        self.mode_launches[mode_of(n)] += 1

    def normalize(self, log_w: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.on_cpu(log_w, *([] if mask is None else [mask])):
            return normalize_log_weights_plain(log_w, mask)
        n = log_w.shape[0]
        self.expect(log_w, "log_w", torch.float32, (n,))
        if mask is not None:
            self.expect(mask, "mask", torch.bool, (n,))
        out = torch.empty_like(log_w)
        if n == 0:
            return out
        err = _build.library().pyabc_normalize_log_weights(
            log_w.data_ptr(), self.ptr(mask), n, out.data_ptr(),
            _build.stream_ptr(log_w.device))
        _build.check(err, self.name)
        self._count("normalize", n)
        return out

    def quantile_epsilon(self, d: torch.Tensor, k_mask: torch.Tensor,
                         w_norm: torch.Tensor | None, weighted: bool,
                         alpha: float, multiplier: float) -> torch.Tensor:
        """The generation step's epsilon (``quantile_epsilon_plain``) in
        one launch; ``k_mask`` any mask (K24b's shard-blocked one too)."""
        w = w_norm if weighted else None
        if self.on_cpu(d, k_mask, *([] if w is None else [w])):
            return quantile_epsilon_plain(d, k_mask, w_norm, weighted, alpha,
                                          multiplier)
        self.expect(k_mask, "k_mask", torch.bool, (d.shape[0],))
        return self._epsilon(d, k_mask, w, alpha, multiplier)

    def quantile(self, points: torch.Tensor, weights: torch.Tensor,
                 alpha: float) -> torch.Tensor:
        """The weighted alpha-quantile of every point (weights >= 0)."""
        if self.on_cpu(points, weights):
            return weighted_quantile_plain(points, weights, alpha)
        return self._epsilon(points, None, weights, alpha, 1.0)

    def _epsilon(self, d, mask, w, alpha, multiplier) -> torch.Tensor:
        n = d.shape[0]
        if n == 0:
            raise ValueError(f"{self.name}: no points")
        self.expect(d, "points", torch.float32, (n,))
        if w is not None:
            self.expect(w, "weights", torch.float32, (n,))
        dev = d.device
        out = torch.empty((), dtype=torch.float32, device=dev)
        ws = None
        if mode_of(n) == "passes":
            # select.cuh's workspace for one weighted column, then the
            # masked points and weights and the quantile
            ws = torch.empty(STATE_BYTES + BINS * 12 + (2 * n + 1) * 4,
                             dtype=torch.uint8, device=dev)
        err = _build.library().pyabc_quantile_epsilon(
            d.data_ptr(), self.ptr(mask), self.ptr(w), n, float(alpha),
            float(multiplier), self.ptr(ws), out.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self._count("epsilon", n)
        return out


normalize_quantile = NormalizeQuantile()
