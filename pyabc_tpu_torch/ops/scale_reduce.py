"""Moment blocks of the adaptive scale refit under segmented early reject
(``pyabc_tpu/ops/scale_reduce.py`` counterpart, in plain torch).

Under early reject a candidate retires after a prefix of its segments, so
a refit over completed candidates alone would be biased toward the
survivors. Instead every resolved candidate folds the columns it simulated
into a fixed ``(MOMENT_ROWS, C)`` float32 block while the generation runs
(sum, sum of squares, sum of |x - x0|, count, max, min), and the scale is
finished from the block at the generation step. Only scale functions with
such a moment form qualify (``SHARDED_SCALE_NAMES``). Variance-bearing
scales use the one-pass ``max(E[x^2] - mean^2, 0)``, a declared deviation
of the JAX package from its two-pass form that the port copies.

These are the plain versions the K22 kernels (``kernels/moments.py``) are
held to; the port keeps its own copy and imports nothing of the JAX
package.
"""
from __future__ import annotations

import math

import torch

#: rows of the moment block: sum, sum of squares, sum of absolute
#: deviations from the observation, count, max, min
MOMENT_ROWS = 6

#: scale-function names expressible over the moment block
SHARDED_SCALE_NAMES = frozenset({
    "mean", "bias", "span", "standard_deviation",
    "root_mean_square_deviation",
    "mean_absolute_deviation_to_observation",
    "standard_deviation_to_observation",
})


def init_moments(C: int, device=None) -> torch.Tensor:
    """Zero moment block, the extrema seeded at -inf / +inf."""
    z = torch.zeros(C, dtype=torch.float32, device=device)
    return torch.stack([z, z, z, z, torch.full_like(z, -math.inf),
                        torch.full_like(z, math.inf)])


def accumulate_moments(mom: torch.Tensor, cols: torch.Tensor,
                       take: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Fold one round's ``cols (B, C)`` into ``mom``: ``take`` is ``(B,)``
    (every column of a taken row) or ``(B, C)`` (per-column eligibility:
    a retired candidate's simulated prefix). Returns the new block."""
    per_col = take.dim() == 2
    t = take if per_col else take[:, None]
    zero = torch.zeros((), dtype=cols.dtype, device=cols.device)
    csum = torch.where(t, cols, zero).sum(0)
    csq = torch.where(t, cols * cols, zero).sum(0)
    cad = torch.where(t, (cols - x0[None, :]).abs(), zero).sum(0)
    if per_col:
        cnt = take.sum(0).to(torch.float32)
    else:
        cnt = take.sum().to(torch.float32).expand(cols.shape[1])
    cmax = torch.where(t, cols, torch.full_like(zero, -math.inf)).amax(0)
    cmin = torch.where(t, cols, torch.full_like(zero, math.inf)).amin(0)
    return torch.stack([mom[0] + csum, mom[1] + csq, mom[2] + cad,
                        mom[3] + cnt, torch.maximum(mom[4], cmax),
                        torch.minimum(mom[5], cmin)])


def combine_moments(parts: torch.Tensor) -> torch.Tensor:
    """Merge stacked blocks ``(n, MOMENT_ROWS, C)``: sums add in order,
    extrema reduce."""
    sums = parts[:, :4].sum(0)
    return torch.cat([sums, parts[:, 4].amax(0)[None],
                      parts[:, 5].amin(0)[None]])


def _n(mom):
    return torch.clamp_min(mom[3], 1.0)


def _mean(mom):
    return mom[0] / _n(mom)


def _var(mom):
    mu = _mean(mom)
    return torch.clamp_min(mom[1] / _n(mom) - mu * mu, 0.0)


def _std_to_obs(mom, x0):
    # (sum x^2 - 2 x0 sum x + n x0^2) / n, in the JAX package's order
    num = (mom[1] - (2.0 * x0) * mom[0]) + (mom[3] * x0) * x0
    return torch.sqrt(torch.clamp_min(num / _n(mom), 0.0))


_FINISHERS = {
    "mean": lambda mom, x0: _mean(mom),
    "bias": lambda mom, x0: (_mean(mom) - x0).abs(),
    "span": lambda mom, x0: mom[4] - mom[5],
    "standard_deviation": lambda mom, x0: torch.sqrt(_var(mom)),
    "root_mean_square_deviation": lambda mom, x0: torch.sqrt(
        (_mean(mom) - x0) * (_mean(mom) - x0) + _var(mom)),
    "mean_absolute_deviation_to_observation":
        lambda mom, x0: mom[2] / _n(mom),
    "standard_deviation_to_observation": _std_to_obs,
}


def scale_from_moments(name: str):
    """The finisher ``fn(mom, x0) -> (C,)`` of a scale name, or None."""
    return _FINISHERS.get(name)
