"""K24b: the shard quotas, the kept-row mask and the generation's totals of
a sharded fused generation (``ABCSMC(..., sharded=n)``).

Counterpart of ``pyabc_tpu/ops/shard.py::{shard_quota, shard_mask}`` as
``pyabc_tpu/inference/util.py::_multigen_sharded`` traces them after the
shards' round loops (``:2655-2668``); the CUDA kernel is
``csrc/shard_mask.cu``. ``shard_mask(counters, table, n_shards=,
cap_loc=)`` reads the generation's ``(5,)`` counters and its ``(n, 4)``
counter table in device memory and returns the ``(n,)`` int32 quotas, the
``(n * cap_loc,)`` bool mask of the kept rows and the ``(6,)`` int32
summary ``[sum n_acc, max rounds, sum n_valid, eps_at_min, n_target,
gen_ok]``: the first five in a generation's counters layout, gen_ok that
every shard met ``min(quota, cap_loc)``. Nothing is read by the host.
"""
from __future__ import annotations

import torch

from ..ops.shard import shard_mask as shard_mask_rows
from ..ops.shard import shard_quota
from . import _build
from .base import Kernel


def shard_mask_plain(counters: torch.Tensor, table: torch.Tensor, *,
                     n_shards: int, cap_loc: int):
    """Plain PyTorch version -> (quota, mask, summary)."""
    quota = shard_quota(counters[4], n_shards)
    nacc = table[:, 0]
    mask = shard_mask_rows(nacc, quota, n_shards, cap_loc)
    ok = (nacc >= torch.clamp_max(quota, cap_loc)).all()
    summary = torch.stack([v.to(torch.int32) for v in (
        nacc.sum(), table[:, 1].max(), table[:, 2].sum(), counters[3],
        counters[4], ok)])
    return quota, mask, summary


class ShardMask(Kernel):
    name = "shard_mask"
    source = "pyabc_tpu_torch/csrc/shard_mask.cu"
    replaces = "pyabc_tpu/ops/shard.py:79"

    def __call__(self, counters: torch.Tensor, table: torch.Tensor, *,
                 n_shards: int, cap_loc: int):
        if self.on_cpu(counters, table):
            return shard_mask_plain(counters, table, n_shards=n_shards,
                                    cap_loc=cap_loc)
        i32 = torch.int32
        self.expect(counters, "counters", i32, (5,))
        self.expect(table, "table", i32, (n_shards, 4))
        dev = counters.device
        quota = torch.empty(n_shards, dtype=i32, device=dev)
        mask = torch.empty(n_shards * cap_loc, dtype=torch.bool, device=dev)
        summary = torch.empty(6, dtype=i32, device=dev)
        err = _build.library().pyabc_shard_mask(
            n_shards, cap_loc, counters.data_ptr(), table.data_ptr(),
            quota.data_ptr(), mask.data_ptr(), summary.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return quota, mask, summary


shard_mask = ShardMask()
