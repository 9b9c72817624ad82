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
- :func:`shard_mask`: the kept rows over the shard-blocked layout (K24b).
"""
from __future__ import annotations

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
