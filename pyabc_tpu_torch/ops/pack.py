"""Fetch compaction (``pyabc_tpu/ops/pack.py`` counterpart; K10 in ROADMAP
queue B).

Before the once-per-chunk host read, theta, distance and log_weight of the
accepted rows collapse into one narrowed-dtype ``(G, n_keep, d + 2)``
buffer; sum stats ship in the same dtype only for the generations History
stores, and a run over several models adds each row's model index as
int8. The distance rounds DOWN when narrowed, so the stored invariant
``distance <= eps_used`` survives the cast. Both go through the K10
wrapper (``kernels/pack_fetch.py``): the CUDA kernel on CUDA tensors, the
plain version on the CPU.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..kernels.pack_fetch import cast_monotone_down, pack_fetch

__all__ = ["DTYPES", "cast_monotone_down", "fetch_dtype_of", "pack_models",
           "pack_rows", "pack_sumstats", "unpack_rows"]

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


def pack_rows(theta, distance, log_weight, *, n_keep: int,
              dtype: torch.dtype, merge=None) -> torch.Tensor:
    """G generations of ``(n_cap, d)``, ``(n_cap,)``, ``(n_cap,)`` (a
    sequence of tensors or one stacked tensor each) -> ``(G, n_keep, d +
    2)`` in ``dtype``; ``merge = (ns, n_shards, cap_loc)`` gathers each
    generation's kept rows from a shard-blocked reservoir (K24c)."""
    return pack_fetch.rows(list(theta), list(distance), list(log_weight),
                           n_keep=n_keep, dtype=dtype, merge=merge)


def pack_sumstats(rows: Sequence[torch.Tensor], *, n_keep: int,
                  dtype: torch.dtype, merge=None) -> torch.Tensor:
    """G generations of ``(n_cap, S)`` -> ``(G, n_keep, S)`` in ``dtype``."""
    return pack_fetch.sumstats(list(rows), n_keep=n_keep, dtype=dtype,
                               merge=merge)


def pack_models(ms: Sequence[torch.Tensor], *, n_keep: int,
                merge=None) -> torch.Tensor:
    """G generations' model columns ``(n_cap,)`` int32 -> ``(G, n_keep)``
    int8 (a run over several models)."""
    return pack_fetch.models(list(ms), n_keep=n_keep, merge=merge)


def unpack_rows(rows, d: int):
    """Host-side split -> (theta f32, distance f64, log_weight f64)."""
    rows = np.asarray(rows)
    return (rows[..., :d].astype(np.float32),
            rows[..., d].astype(np.float64),
            rows[..., d + 1].astype(np.float64))
