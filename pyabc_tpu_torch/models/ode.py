"""Fixed-step RK4 on batched tensors (``pyabc_tpu/models/ode.py``
counterpart, plain PyTorch).

The state is ``(state_dim, B)``: every lane of a proposal round integrates
at once, and each step follows the JAX package's operation order so that
float32 results agree to rounding.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def rk4_dt(ts, n_substeps: int) -> float:
    """The float32 micro step ``(ts[1] - ts[0]) / n_substeps`` as JAX
    computes it (``ts`` becomes a float32 array first)."""
    ts32 = np.asarray(ts, np.float32)
    return float((ts32[1] - ts32[0]) / np.float32(n_substeps))


def rk4_at_times(f: Callable, y0: torch.Tensor, n_obs: int,
                 n_substeps: int, dt: float) -> torch.Tensor:
    """RK4 trajectory at ``n_obs`` uniformly spaced times: row 0 is ``y0``
    itself, each later row follows ``n_substeps`` RK4 steps of ``dt``.

    ``f(y) -> dy`` maps a ``(state_dim, B)`` state to its derivative.
    Returns ``(n_obs, state_dim, B)``."""
    dt32 = np.float32(dt)
    h2 = float(np.float32(0.5) * dt32)
    h6 = float(dt32 / np.float32(6.0))
    dtf = float(dt32)
    y = y0
    out = [y0]
    for _ in range(n_obs - 1):
        for _ in range(n_substeps):
            k1 = f(y)
            k2 = f(y + h2 * k1)
            k3 = f(y + h2 * k2)
            k4 = f(y + dtf * k3)
            y = y + h6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return torch.stack(out)
