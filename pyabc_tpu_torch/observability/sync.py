"""Device -> host read accounting (``pyabc_tpu/observability/sync.py``
counterpart, reduced to a counter).

Every place where the host waits on a device value (the per-round counter
read, the per-chunk packed fetch) records one event here, so a run can
report its syncs per generation.
"""
from __future__ import annotations

import threading
from collections import Counter


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

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._bytes.clear()
