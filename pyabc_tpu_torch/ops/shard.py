"""Shard math of sharded fused sampling (``pyabc_tpu/ops/shard.py``
counterpart; the port keeps its own copy and imports nothing of the JAX
package).

``ABCSMC(..., sharded=n)`` splits a generation's lanes and its reservoir
into ``n`` shards (the lane-key reduction): global lane ``i`` keeps the
Philox stream it has unsharded, shard ``s`` owns the lanes ``[s*B_loc,
(s+1)*B_loc)`` and compacts its accepted lanes into its own reservoir block
of ``cap_loc = n_cap / n`` rows, ``[s*cap_loc, (s+1)*cap_loc)``, up to its
quota of the generation's n. The helpers here:

- :func:`shard_quota_host` / :func:`shard_quota`: each shard's quota, the
  remainder of an uneven n on the leading shards;
- :func:`merge_index`: the gather of a generation's kept rows from the
  shard-blocked layout into dense accepted order (K24c computes it inside
  the fetch kernel);
- :func:`shard_mask`: the kept rows over the shard-blocked layout (K24b);
- :func:`rank_block`: a device mesh rank's block of shards, lanes and rows.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def shard_quota_host(n_target: int, n_shards: int) -> np.ndarray:
    """Per-shard accepted-row quotas of a generation target (host side):
    the first ``n_target % n_shards`` shards take one row more."""
    base, extra = divmod(int(n_target), int(n_shards))
    return np.asarray(
        [base + (1 if s < extra else 0) for s in range(int(n_shards))],
        np.int32)


def shard_quota(n_target, n_shards: int, device=None) -> torch.Tensor:
    """Tensor twin of :func:`shard_quota_host` for a target that may be a
    0-dim device int32: ``(n_shards,)`` int32."""
    n_target = torch.as_tensor(n_target, dtype=torch.int32, device=device)
    base = torch.div(n_target, n_shards, rounding_mode="floor")
    extra = n_target - base * n_shards
    ar = torch.arange(n_shards, dtype=torch.int32, device=n_target.device)
    return (base + (ar < extra).to(torch.int32)).to(torch.int32)


def merge_index(n_keep: int, n_shards: int, cap_loc: int) -> np.ndarray:
    """Gather indices merging the shard-blocked reservoir into dense
    accepted-row order: shard ``s`` keeps its first ``quota[s]`` rows at
    ``[s*cap_loc, s*cap_loc + quota[s])``, taken back to back."""
    quota = shard_quota_host(n_keep, n_shards)
    if int(quota.max(initial=0)) > cap_loc:
        raise ValueError(
            f"shard quota {int(quota.max())} exceeds per-shard reservoir "
            f"capacity {cap_loc} (n_keep={n_keep}, n_shards={n_shards})")
    parts = [s * cap_loc + np.arange(quota[s], dtype=np.int32)
             for s in range(n_shards)]
    return np.concatenate(parts) if parts else np.zeros(0, np.int32)


def shard_mask(nacc_sh: torch.Tensor, quota_sh: torch.Tensor, n_shards: int,
               cap_loc: int) -> torch.Tensor:
    """The kept rows over the shard-blocked layout: row ``j`` (shard ``j //
    cap_loc``, offset ``j % cap_loc``) is kept iff its offset is below both
    its shard's quota and its shard's acceptance count."""
    j = torch.arange(n_shards * cap_loc, device=nacc_sh.device)
    lim = torch.minimum(nacc_sh, quota_sh)
    return (j % cap_loc) < lim[j // cap_loc]


class RankBlock(NamedTuple):
    """Rank ``rank``'s part of a sharded generation on a mesh of width w
    (``util.py:2560-2570``): the global shards ``[shard0, shard0 + v)``,
    their lanes ``[lane0, lane0 + lanes)`` of the round and their reservoir
    rows ``[row0, row0 + rows)``; ``quota`` their slice of the global
    quotas and ``target`` its sum."""

    shard0: int
    v: int
    lane0: int
    lanes: int
    row0: int
    rows: int
    quota: np.ndarray
    target: int


def rank_block(n_target: int, n_shards: int, width: int, rank: int, *,
               B: int, n_cap: int) -> RankBlock:
    """Rank ``rank``'s block of an ``n_shards``-shard generation of target
    ``n_target`` over ``B`` lanes and ``n_cap`` rows. The extra rows of an
    uneven n sit on the leading shards, so the slice of the global quotas
    is the quotas of ``target`` over v shards: the kernels that compute a
    shard's quota from the target (K24a, K24d) run the rank's v shards on
    ``target`` unchanged."""
    if n_shards % width or B % n_shards or n_cap % n_shards:
        raise ValueError(f"a width {width} mesh needs it to divide "
                         f"{n_shards} shards, which divide B {B} and n_cap "
                         f"{n_cap}")
    v = n_shards // width
    shard0 = rank * v
    quota = shard_quota_host(n_target, n_shards)[shard0:shard0 + v]
    b_loc, cap_loc = B // n_shards, n_cap // n_shards
    return RankBlock(shard0=shard0, v=v, lane0=shard0 * b_loc,
                     lanes=v * b_loc, row0=shard0 * cap_loc,
                     rows=v * cap_loc, quota=quota,
                     target=int(quota.sum()))
