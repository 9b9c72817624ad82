"""Device-side weighted statistics (``pyabc_tpu/ops/stats.py`` counterpart).
Both go through the K7 wrapper (``kernels/normalize_quantile.py``): the
CUDA kernel on a CUDA tensor, the plain version on the CPU."""
from __future__ import annotations

import torch

from ..kernels.normalize_quantile import normalize_quantile


def weighted_quantile(points: torch.Tensor, weights: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Step-function weighted quantile: min{v : W(<= v) >= alpha W}."""
    return normalize_quantile.quantile(points, weights, alpha)


def normalize_log_weights(log_w: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """exp-normalize masked log-weights to sum to 1; an all-masked (or all
    -inf) input gives all zeros instead of NaN."""
    return normalize_quantile.normalize(log_w, mask)
