"""Neighbour selection for LocalTransition's covariance field
(``pyabc_tpu/ops/select.py`` counterpart): the plain versions that K12
(``kernels/local_cov.py``) repeats operation for operation.

- :func:`radius_bisect`: a fixed-iteration bisection on each row's radius
  over a (rows, n) squared-distance tile; the count-feasible upper bound
  is kept, so ``count(sq <= r) >= k``.
- :func:`compact_within_radius`: candidates with ``sq <= r`` left-compacted
  in candidate order into a ``(rows, k_cap)`` index buffer, with the count
  clipped to the buffer.
- :func:`threshold_neighbors`: both in one call; with ``stride > 1`` the
  whole selection runs on the ``[::stride]`` candidate subsample with the
  count target ``ceil(k / stride)`` and a ``ceil(k_cap / stride)`` buffer.
- :func:`apply_rowwise_blocked`: changed rows take new values, the others
  keep the old ones, and the number of changed rows is returned.
"""
from __future__ import annotations

import torch

#: below this static k bound the exact top-k is cheap: selection "auto"
#: keeps it there and bisects above it
DEFAULT_TOPK_CUTOFF = 1024
#: bisection iterations (about the float32 mantissa width)
DEFAULT_BISECT_ITERS = 26


def default_stride(n: int) -> int:
    """Candidate stride of the bisection: 1 up to moderate n, 4 beyond."""
    return 4 if n >= 8192 else 1


def radius_bisect(sq: torch.Tensor, k, *,
                  n_iters: int = DEFAULT_BISECT_ITERS) -> torch.Tensor:
    """Per-row radius r with ``count(sq <= r) >= k``: hi0 the row's finite
    max (0 when none), lo0 0, then ``n_iters`` steps of ``mid = 0.5 (lo +
    hi)``, keeping hi where the count reaches k. ``sq`` (rows, n) float32,
    excluded candidates +inf; ``k`` an int or a 0-dim tensor."""
    finite = torch.isfinite(sq)
    hi = torch.where(finite, sq, torch.full_like(sq, -torch.inf)).amax(dim=1)
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    lo = torch.zeros_like(hi)
    k_t = torch.as_tensor(k, device=sq.device).to(sq.dtype)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        cnt = (sq <= mid[:, None]).sum(dim=1).to(sq.dtype)
        ok = cnt >= k_t
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    return hi


def compact_within_radius(sq: torch.Tensor, r: torch.Tensor, k_cap: int):
    """-> (idx (rows, k_cap) int32, cnt (rows,) int32): the candidates with
    ``sq <= r`` in candidate order, 0 past ``cnt``; ``cnt`` is clipped to
    ``k_cap``."""
    rows, n = sq.shape
    mask = sq <= r[:, None]
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    keep = mask & (rank < k_cap)
    idx = torch.zeros(rows, k_cap + 1, dtype=torch.int32, device=sq.device)
    pos = torch.where(keep, rank, torch.full_like(rank, k_cap))
    cand = torch.arange(n, dtype=torch.int32, device=sq.device).expand(rows,
                                                                       n)
    idx.scatter_(1, pos, torch.where(keep, cand, torch.zeros_like(cand)))
    cnt = torch.clamp(mask.sum(dim=1), max=k_cap).to(torch.int32)
    return idx[:, :k_cap].contiguous(), cnt


def threshold_neighbors(sq: torch.Tensor, k, k_cap: int, *,
                        n_iters: int = DEFAULT_BISECT_ITERS,
                        stride: int = 1):
    """Bisection and compaction in one call -> (idx, cnt, r); with ``stride
    > 1`` on ``sq[:, ::stride]``, the indices mapped back (x stride)."""
    if stride > 1:
        sub = sq[:, ::stride]
        k_sub = (k + stride - 1) // stride
        k_cap_sub = -(-k_cap // stride)
    else:
        sub, k_sub, k_cap_sub = sq, k, k_cap
    r = radius_bisect(sub, k_sub, n_iters=n_iters)
    idx, cnt = compact_within_radius(sub, r, k_cap_sub)
    if stride > 1:
        idx = idx * stride
    return idx, cnt, r


def apply_rowwise_blocked(fn, changed: torch.Tensor, prev_outs, *row_inputs):
    """Run ``fn`` on the rows flagged ``changed`` and scatter its outputs
    over ``prev_outs`` -> (outs, n_changed). ``fn(*rows) -> tuple`` takes
    each of ``row_inputs`` gathered to the changed rows."""
    ids = torch.nonzero(changed).squeeze(1)
    outs = tuple(o.clone() for o in prev_outs)
    if ids.numel():
        res = fn(*(x[ids] for x in row_inputs))
        for o, r in zip(outs, res):
            o[ids] = r.to(o.dtype)
    return outs, changed.sum().to(torch.int32)
