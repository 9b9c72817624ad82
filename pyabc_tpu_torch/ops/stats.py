"""Device-side weighted statistics (``pyabc_tpu/ops/stats.py`` counterpart,
plain PyTorch; K7 in ROADMAP queue B)."""
from __future__ import annotations

import torch


def weighted_quantile(points: torch.Tensor, weights: torch.Tensor,
                      alpha: float) -> torch.Tensor:
    """Step-function weighted quantile: stable sort, cumsum, left search."""
    order = torch.argsort(points, stable=True)
    p = points[order]
    cum = torch.cumsum(weights[order], 0)
    cdf = cum / cum[-1]
    a = torch.full((1,), float(alpha), dtype=cdf.dtype, device=cdf.device)
    idx = torch.searchsorted(cdf, a, side="left").clamp(0, p.shape[0] - 1)
    return p[idx][0]


def normalize_log_weights(log_w: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
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
