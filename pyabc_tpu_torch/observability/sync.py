"""Device -> host read accounting (``pyabc_tpu/observability/sync.py``
counterpart, reduced to a counter).

Every place where the host waits on a device value (the per-round counter
read, the per-chunk packed fetch) records one event here, so a run can
report its syncs per generation. A device mesh's gather (``mesh_gather``,
one a generation, ``parallel/mesh.py``) records the bytes it gathered: the
counterpart of the JAX engine snapshot's ``mesh`` block, with
``ABCSMC.mesh_snapshot()``.
"""
from __future__ import annotations

import threading
from collections import Counter

import torch


class SyncLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._counts: Counter = Counter()
        self._bytes: Counter = Counter()

    def record(self, kind: str, nbytes: int = 0) -> None:
        with self._lock:
            self._counts[kind] += 1
            self._bytes[kind] += int(nbytes)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts.values())

    def summary(self) -> dict:
        with self._lock:
            return {"syncs": sum(self._counts.values()),
                    "by_kind": dict(self._counts),
                    "bytes": dict(self._bytes)}

    def budget_report(self, *, rounds: int, chunks: int,
                      slack: int = 8) -> dict:
        """The port's sync budget (``pyabc_tpu``'s ``syncs_per_run <=
        chunks + O(1)``, with the round loop on the host): one counter
        read a round, a sharded round's included (its ``(n, 4)`` table
        rides the same read), one packed fetch a chunk, and ``slack``
        reads of O(1) (a host calibration's collect, a boundary's
        reads) -> ``{"ok", "syncs", "rounds", "chunks", "by_kind"}``."""
        with self._lock:
            syncs = sum(self._counts.values())
            by_kind = dict(self._counts)
        return {"ok": syncs <= rounds + chunks + slack, "syncs": syncs,
                "rounds": rounds, "chunks": chunks, "by_kind": by_kind}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._bytes.clear()


def to_host(tree: dict, ledger: SyncLedger, kind: str) -> dict:
    """One device -> host read of every tensor of ``tree``: non-blocking
    copies into pinned buffers behind one event, then one wait on it,
    recorded in ``ledger`` as ``kind`` -> numpy arrays (bfloat16 widened to
    float32)."""
    out, nbytes, cuda = {}, 0, None
    for k, v in tree.items():
        if v.device.type == "cuda":
            cuda = v.device
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
        else:
            h = v.detach().clone()
        out[k] = h
        nbytes += v.numel() * v.element_size()
    if cuda is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(cuda))
        done.synchronize()
    ledger.record(kind, nbytes)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in out.items()}
