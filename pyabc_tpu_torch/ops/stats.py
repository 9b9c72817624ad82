"""Device-side weighted statistics (``pyabc_tpu/ops/stats.py`` counterpart).
All three go through the K7 wrapper (``kernels/normalize_quantile.py``): the
CUDA kernel on a CUDA tensor, the plain version on the CPU."""
from __future__ import annotations

import torch

from ..kernels.normalize_quantile import normalize_quantile


def weighted_quantile(points: torch.Tensor, weights: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Step-function weighted quantile: min{v : W(<= v) >= alpha W}."""
    return normalize_quantile.quantile(points, weights, alpha)


def quantile_epsilon(d: torch.Tensor, k_mask: torch.Tensor,
                     w_norm: torch.Tensor | None, weighted: bool,
                     alpha: float, multiplier: float) -> torch.Tensor:
    """The next epsilon from the kept rows' distances: their (weighted)
    alpha-quantile times ``multiplier``, masked rows left out (one
    launch)."""
    return normalize_quantile.quantile_epsilon(d, k_mask, w_norm, weighted,
                                               alpha, multiplier)


def normalize_log_weights(log_w: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """exp-normalize masked log-weights to sum to 1; an all-masked (or all
    -inf) input gives all zeros instead of NaN."""
    return normalize_quantile.normalize(log_w, mask)
