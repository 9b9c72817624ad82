"""A rank's view of a device mesh and the mesh's one collective, the
gather (the ``pyabc_tpu/inference/util.py::_HybridShards`` counterpart).

The JAX package runs a mesh as one ``shard_map`` whose per-generation
collectives all-gather each device's block of the shards' columns in device
order (``_HybridShards.rows``, ``util.py:2575-2582``). The port runs it as
w processes, one device each: rank d owns the global shards ``[d v, (d + 1)
v)`` (v = n / w), their lanes and their reservoir blocks, runs its
generation with no collective inside, packs what the replicated stage reads
into one buffer (K24e, ``kernels/mesh_pack.py``) and gathers the w buffers
in rank order; the unpack then tiles them into the global shard-blocked
arrays, which are the virtual-shard run's bit for bit.

Transport: Gloo. A buffer on the card is staged through pinned host memory
(one device-to-host copy, ``dist.all_gather`` over host tensors, one
host-to-device copy), so a single card can hold every rank (NCCL needs one
card a rank, and a mesh over an NCCL group is refused). Each gather is
recorded in the run's ``SyncLedger`` as ``mesh_gather`` with the bytes
gathered; ``MeshRank.stats`` keeps its staging and Gloo seconds.

A rank's failure fails the run: the group's timeout bounds every gather,
and nothing falls back to a local run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..observability.sync import SyncLedger
from ..utils import not_ported


@dataclass
class MeshRank:
    """A one-dimensional ``DeviceMesh`` as one rank of a sharded run sees
    it: its process group, the width w and its rank in mesh order."""

    group: object
    width: int
    rank: int
    #: gathers, bytes gathered, the staging and Gloo seconds, and this
    #: rank's rounds of each gathered generation
    stats: dict = field(default_factory=lambda: {
        "gathers": 0, "bytes": 0, "stage_s": 0.0, "gloo_s": 0.0,
        "rounds": []})

    @classmethod
    def of(cls, mesh, device: torch.device) -> "MeshRank":
        """The rank's view of ``mesh``: a one-dimensional ``DeviceMesh``
        over a Gloo group whose device type is the run's."""
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
            raise TypeError(
                f"mesh must be a one-dimensional torch DeviceMesh "
                f"(parallel.distributed.global_mesh()), got "
                f"{type(mesh).__name__}"
                + (f" of {mesh.ndim} dimensions"
                   if isinstance(mesh, DeviceMesh) else ""))
        group = mesh.get_group()
        backend = str(dist.get_backend(group)).lower()
        if "nccl" in backend:
            raise not_ported(
                "a device mesh over an NCCL group (NCCL collectives need "
                "one card a rank; the mesh's gathers run over Gloo)", "15")
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh's device type {mesh.device_type!r} "
                             f"is not the run's device {str(device)!r}")
        return cls(group=group, width=int(mesh.size()),
                   rank=int(mesh.get_local_rank()))

    def gather(self, send: torch.Tensor, ledger: SyncLedger
               ) -> tuple[np.ndarray, torch.Tensor]:
        """All-gather the ``(W,)`` int32 words of every rank in rank order
        -> (the ``(w, W)`` words on the host, the same on ``send``'s
        device). A card buffer is staged through pinned memory; one
        ``mesh_gather`` is recorded with the gathered bytes."""
        w, W = self.width, send.shape[0]
        t0 = time.perf_counter()
        cuda = send.device.type == "cuda"
        if cuda:
            host = torch.empty(W, dtype=torch.int32, pin_memory=True)
            host.copy_(send, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(send.device))
            done.synchronize()
            recv = torch.empty(w, W, dtype=torch.int32, pin_memory=True)
        else:
            host = send
            recv = torch.empty(w, W, dtype=torch.int32)
        t1 = time.perf_counter()
        dist.all_gather(list(recv.unbind(0)), host, group=self.group)
        t2 = time.perf_counter()
        out = recv.to(send.device, non_blocking=True) if cuda else recv
        t3 = time.perf_counter()
        nbytes = w * W * 4
        ledger.record("mesh_gather", nbytes)
        st = self.stats
        st["gathers"] += 1
        st["bytes"] += nbytes
        st["stage_s"] += (t1 - t0) + (t3 - t2)
        st["gloo_s"] += t2 - t1
        return recv.numpy(), out

    def snapshot(self) -> dict:
        """The mesh block of a run (``pyabc_tpu``'s engine snapshot
        ``["mesh"]``): devices, gathers, bytes, staging and Gloo ms a
        gather, and this rank's rounds of each gathered generation."""
        st = self.stats
        g = max(st["gathers"], 1)
        return {"devices": self.width, "rank": self.rank,
                "gathers": st["gathers"], "gather_bytes": st["bytes"],
                "bytes_per_gather": st["bytes"] / g,
                "stage_ms_per_gather": 1e3 * st["stage_s"] / g,
                "gloo_ms_per_gather": 1e3 * st["gloo_s"] / g,
                "rounds_per_generation": list(st["rounds"])}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s ``torch.Generator`` (the draws of a user
    simulator): the run's seed on the primary, a distinct 63-bit word on
    every other rank, so no two ranks draw the same noise."""
    if rank == 0:
        return int(seed)
    return (int(seed) * 0x9E3779B97F4A7C15 + rank * 0xBF58476D1CE4E5B9) \
        & ((1 << 63) - 1)
