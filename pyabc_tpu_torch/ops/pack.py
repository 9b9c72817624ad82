"""Fetch compaction (``pyabc_tpu/ops/pack.py`` counterpart, plain PyTorch;
K10 in ROADMAP queue B).

Before the once-per-chunk host read, theta, distance and log_weight of the
accepted rows collapse into one narrowed-dtype ``(G, n_keep, d + 2)``
buffer; sum stats ship in the same dtype only for the generations History
stores. The distance rounds DOWN when narrowed, so the stored invariant
``distance <= eps_used`` survives the cast.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def fetch_dtype_of(name: str) -> torch.dtype:
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported fetch_dtype {name!r}: one of "
                         f"{sorted(DTYPES)}") from None


def cast_monotone_down(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Narrowing cast whose result never exceeds ``x``."""
    if dtype == torch.float32:
        return x.to(dtype)
    step = 2.0 ** -10 if dtype == torch.float16 else 2.0 ** -7
    down = x * torch.where(x >= 0, 1.0 - step, 1.0 + step)
    cast = x.to(dtype)
    over = cast.to(x.dtype) > x
    return torch.where(over, down.to(dtype), cast)


def pack_rows(theta: torch.Tensor, distance: torch.Tensor,
              log_weight: torch.Tensor, *, n_keep: int,
              dtype: torch.dtype) -> torch.Tensor:
    """``(G, n_cap, d)``, ``(G, n_cap)``, ``(G, n_cap)`` ->
    ``(G, n_keep, d + 2)`` in ``dtype``."""
    return torch.cat([
        theta[:, :n_keep].to(dtype),
        cast_monotone_down(distance[:, :n_keep, None], dtype),
        log_weight[:, :n_keep, None].to(dtype),
    ], dim=-1)


def unpack_rows(rows, d: int):
    """Host-side split -> (theta f32, distance f64, log_weight f64)."""
    rows = np.asarray(rows)
    return (rows[..., :d].astype(np.float32),
            rows[..., d].astype(np.float64),
            rows[..., d + 1].astype(np.float64))
