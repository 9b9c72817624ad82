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

K12's selection as its kernel computes it, for the tests and as its
documentation (nothing on the main path calls these):

- :func:`kth_key`: each row's k-th smallest distance as the kernel's
  radix select finds it, on the float bits read as unsigned integers
  (for distances >= +0 the same order as their values; NaN above +inf).
- :func:`radius_from_kth`: :func:`radius_bisect`'s radius from that value
  alone: ``count(sq <= mid) >= k`` holds exactly when ``mid >= V``, so the
  bisection's steps replay on scalars.
- :func:`topk_from_kth`: the top-k set from that value: every candidate
  below V, then the lowest-index candidates equal to V.
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


def _keys(sq: torch.Tensor) -> torch.Tensor:
    """The float bits of ``sq`` (-0 taken as +0, as the kernel writes its
    distances) read as unsigned 32-bit integers, in int64."""
    sq = torch.where(sq == 0, torch.zeros_like(sq), sq)
    return sq.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def kth_key(sq: torch.Tensor, k: int) -> torch.Tensor:
    """(rows,) int64: the k-th smallest (1-based) of each row's keys
    (:func:`_keys`); -1 where k <= 0, 2^32 where k exceeds the row."""
    rows, n = sq.shape
    if k <= 0:
        return torch.full((rows,), -1, dtype=torch.int64, device=sq.device)
    if k > n:
        return torch.full((rows,), 1 << 32, dtype=torch.int64,
                          device=sq.device)
    return torch.sort(_keys(sq), dim=1).values[:, k - 1]


def radius_from_kth(sq: torch.Tensor, k, *,
                    n_iters: int = DEFAULT_BISECT_ITERS) -> torch.Tensor:
    """:func:`radius_bisect` from the k-th smallest value V alone: hi0 and
    lo0 as there, then ``n_iters`` steps of ``mid = 0.5 (lo + hi)`` with
    ``ok = mid >= V`` (NaN is never counted, so V is NaN where fewer than
    k entries are numbers and ok never holds; +inf counts as a value).
    ``sq`` (rows, n) float32 >= 0 (or -0, +inf, NaN)."""
    k = int(k)
    finite = torch.isfinite(sq)
    hi = torch.where(finite, sq, torch.full_like(sq, -torch.inf)).amax(dim=1)
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    lo = torch.zeros_like(hi)
    key = kth_key(sq, k)
    bits = torch.where((key >= 0) & (key < (1 << 32)), key,
                       torch.full_like(key, 0x7FC00000))
    v = bits.to(torch.int32).view(torch.float32)  # NaN when none is k-th
    if k <= 0:
        v = torch.full_like(hi, -torch.inf)
    for _ in range(n_iters):
        mid = 0.5 * (lo + hi)
        ok = mid >= v
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    return hi


def topk_from_kth(sq: torch.Tensor, k: int, k_cap: int):
    """The k smallest of each row by (key, index) from the k-th smallest
    key V -> (idx (rows, k_cap) int32 in candidate order, 0 past k; cnt
    (rows,) int32 = k): :func:`kernels.local_cov.topk_neighbors`'s set
    for distances >= +0 (+inf and NaN last) and k <= k_cap."""
    rows, n = sq.shape
    k = min(int(k), n)
    keys = _keys(sq)
    v = kth_key(sq, k)[:, None]
    below = keys < v
    eq = keys == v
    need = k - below.sum(dim=1, keepdim=True)
    eq_rank = torch.cumsum(eq.to(torch.int64), dim=1) - 1
    mask = below | (eq & (eq_rank < need))
    idx, _cnt = compact_within_radius(
        torch.where(mask, torch.zeros_like(sq), torch.ones_like(sq)),
        torch.zeros(rows, dtype=sq.dtype, device=sq.device), k_cap)
    cnt = torch.full((rows,), k, dtype=torch.int32, device=sq.device)
    return idx, cnt


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
