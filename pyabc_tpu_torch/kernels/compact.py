"""K6: the mask-and-refill compaction of one proposal round.

Counterpart of the loop body of
``pyabc_tpu/inference/util.py::DeviceContext._generation_while``; the CUDA
kernel is ``csrc/compact_round.cu``. ``res`` is the slot-ordered reservoir
(``theta``, ``sumstats``, ``distance``, ``log_weight``, ``slot``), ``rec``
the record ring (``sumstats``, ``distance``, ``accepted``, ``valid``) or
None, and ``counters`` the int32 device vector ``[n_acc, r, n_valid, ...]``.
Everything is updated in place.

Record mode (a noisy-ABC run, ``_generation_while(record_proposal=True)``):
the ring also holds ``theta`` and ``logq``, each record's parameters and
the log-density of the proposal it was drawn from (the prior's in
generation 0), and the round passes its ``logq``. Without those columns
the compaction is exactly the plain one.

Model column (a run over several models): the reservoir also holds ``m``
(int32) and the round passes each lane's model; it lands on the lane's
reservoir row, bit-exact. Without it nothing changes. The record ring
keeps no model index: nothing on the ported paths reads it.

Ring mask (segmented noisy ABC): ``ring_valid (B,)`` bool, K18's ``keep``,
sets each recorded row's ``valid`` in place of True, so the ring holds
completed evaluations only (the JAX engine's documented behaviour,
``util.py:1086-1107``) while ``n_valid`` still counts every valid slot.

Shard mode (K24a, ``compact_round.shards``; sharded fused sampling,
``ABCSMC(..., sharded=n)``): the vmapped per-shard round step of
``_generation_while`` under ``local_generation`` (``util.py:2404-2420``).
The round's B lanes and the reservoir split into n shards; shard s, unless
it is finished (its accepted count at its quota of ``counters[N_TARGET]``,
or its rounds at ``max_rounds``), compacts its lanes ``[s*B_loc,
(s+1)*B_loc)`` into its rows ``[s*cap_loc, (s+1)*cap_loc)`` in local slot
order and updates its row ``[n_acc, rounds, n_valid, -]`` of the int32
``(n, 4)`` counter table; ``counters[ROUNDS]`` (the round the lanes draw
at) goes up by one. A reservoir with a ``dfeat`` column (an adaptive
distance) also gets each written row's distance features ``|x - x0|^p``,
or, given ``feat_rows (B, F)`` (an adaptive aggregated distance: K25's
sub-distances of the round), the lane's F given values, bit for bit, into
an ``(n_cap, F)`` ``dfeat``. Counted in ``mode_launches["shards"]``, the
given-rows launches also in ``mode_launches["given_rows"]``.
"""
from __future__ import annotations

import math

import torch

from ..ops.shard import shard_quota
from . import _build
from .base import Kernel

#: counters layout slots the shard mode reads and writes
ROUNDS, N_TARGET = 1, 4


def dfeat_rows(ss: torch.Tensor, x0: torch.Tensor, p: float) -> torch.Tensor:
    """Distance features ``|x - x0|^p`` of rows (``pyabc_tpu``
    ``AdaptivePNormDistance.device_sharded_dfeat``'s ``row``), in the
    kernel's arithmetic: one multiply at p = 2, ``|x - x0|`` at p = 1 or
    inf."""
    diff = (ss - x0[None, :]).abs()
    if p == 2:
        return diff * diff
    if p == 1 or math.isinf(p):
        return diff
    return diff ** p


def compact_round_plain(accept, valid, theta, ss, dist, logw, res: dict,
                        rec: dict | None, counters: torch.Tensor,
                        logq: torch.Tensor | None = None,
                        m: torch.Tensor | None = None,
                        ring_valid: torch.Tensor | None = None,
                        x0: torch.Tensor | None = None,
                        p: float = 2.0,
                        feat_rows: torch.Tensor | None = None) -> None:
    """Plain PyTorch version (in place); a reservoir with a ``dfeat``
    column gets the written rows' distance features against ``x0``, or
    their rows of ``feat_rows``."""
    B = accept.shape[0]
    n_cap = res["distance"].shape[0]
    acc = accept & valid
    n_acc0, r = counters[0], counters[1]
    slots = r * B + torch.arange(B, dtype=torch.int32, device=accept.device)
    rank = torch.cumsum(acc.to(torch.int32), 0) - 1
    pos = n_acc0 + rank
    write = acc & (pos < n_cap)
    idx = pos[write].long()
    res["theta"][idx] = theta[write]
    res["sumstats"][idx] = ss[write]
    res["distance"][idx] = dist[write]
    res["log_weight"][idx] = logw[write]
    res["slot"][idx] = slots[write]
    if m is not None:
        res["m"][idx] = m[write]
    if "dfeat" in res:
        res["dfeat"][idx] = (dfeat_rows(ss[write], x0, p) if feat_rows is None
                             else feat_rows[write])
    if rec is not None:
        rec_cap = rec["distance"].shape[0]
        take = valid & (slots < rec_cap)
        ridx = slots[take].long()
        rec["sumstats"][ridx] = ss[take]
        rec["distance"][ridx] = dist[take]
        rec["accepted"][ridx] = acc[take]
        rec["valid"][ridx] = (True if ring_valid is None
                              else ring_valid[take])
        if "theta" in rec:
            rec["theta"][ridx] = theta[take]
            rec["logq"][ridx] = logq[take]
    counters[0] += acc.sum(dtype=torch.int32)
    counters[1] += 1
    counters[2] += valid.sum(dtype=torch.int32)


def compact_shards_plain(accept, valid, theta, ss, dist, logw, res: dict,
                         counters: torch.Tensor, table: torch.Tensor, *,
                         n_shards: int, max_rounds: int,
                         m: torch.Tensor | None = None,
                         x0: torch.Tensor | None = None,
                         p: float = 2.0,
                         feat_rows: torch.Tensor | None = None) -> None:
    """Plain PyTorch version of the shard mode (in place): each running
    shard's block through the plain round, its table row as its
    counters."""
    B_loc = accept.shape[0] // n_shards
    cap_loc = res["distance"].shape[0] // n_shards
    quota = shard_quota(counters[N_TARGET], n_shards)
    counters[ROUNDS] += 1
    for s in range(n_shards):
        if (int(table[s, 0]) >= int(quota[s])
                or int(table[s, 1]) >= max_rounds):
            continue  # finished: its block and row stay as they are
        lanes = slice(s * B_loc, (s + 1) * B_loc)
        block = {k: v[s * cap_loc:(s + 1) * cap_loc] for k, v in res.items()}
        compact_round_plain(accept[lanes], valid[lanes], theta[lanes],
                            ss[lanes], dist[lanes], logw[lanes], block, None,
                            table[s], m=None if m is None else m[lanes],
                            x0=x0, p=p, feat_rows=None if feat_rows is None
                            else feat_rows[lanes])


class CompactRound(Kernel):
    name = "compact_round"
    source = "pyabc_tpu_torch/csrc/compact_round.cu"
    replaces = "pyabc_tpu/inference/util.py:563"

    def __init__(self):
        super().__init__()
        #: shard-mode launches, and those of them with given feature rows
        self.mode_launches = {"shards": 0, "given_rows": 0}

    def __call__(self, accept, valid, theta, ss, dist, logw, res: dict,
                 rec: dict | None, counters: torch.Tensor,
                 logq: torch.Tensor | None = None,
                 m: torch.Tensor | None = None,
                 ring_valid: torch.Tensor | None = None) -> None:
        record = rec is not None and "theta" in rec
        if record != (logq is not None):
            raise ValueError(f"{self.name}: a ring with theta/logq columns "
                             f"and the round's logq go together")
        if ("m" in res) != (m is not None):
            raise ValueError(f"{self.name}: a reservoir with an m column "
                             f"and the round's m go together")
        bufs = list(res.values()) + (list(rec.values()) if rec else [])
        extra = [t for t in (logq, m, ring_valid) if t is not None]
        if self.on_cpu(accept, valid, theta, ss, dist, logw, counters,
                       *bufs, *extra):
            compact_round_plain(accept, valid, theta, ss, dist, logw, res,
                                rec, counters, logq, m, ring_valid)
            return
        B, d = theta.shape
        S = ss.shape[1]
        n_cap = res["distance"].shape[0]
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.expect(accept, "accept", b8, (B,))
        self.expect(valid, "valid", b8, (B,))
        self.expect(theta, "theta", f32, (B, d))
        self.expect(ss, "ss", f32, (B, S))
        self.expect(dist, "dist", f32, (B,))
        self.expect(logw, "logw", f32, (B,))
        self.expect(res["theta"], "res.theta", f32, (n_cap, d))
        self.expect(res["sumstats"], "res.sumstats", f32, (n_cap, S))
        self.expect(res["distance"], "res.distance", f32, (n_cap,))
        self.expect(res["log_weight"], "res.log_weight", f32, (n_cap,))
        self.expect(res["slot"], "res.slot", i32, (n_cap,))
        if m is not None:
            self.expect(m, "m", i32, (B,))
            self.expect(res["m"], "res.m", i32, (n_cap,))
        if ring_valid is not None:
            self.expect(ring_valid, "ring_valid", b8, (B,))
        self.expect(counters, "counters", i32, (counters.shape[0],))
        if counters.shape[0] < 3:
            raise ValueError(f"{self.name}: counters need 3 entries")
        rec_cap = 0
        rec_ptrs = [None, None, None, None]
        record_ptrs = [None, None]
        if rec is not None:
            rec_cap = rec["distance"].shape[0]
            self.expect(rec["sumstats"], "rec.sumstats", f32, (rec_cap, S))
            self.expect(rec["distance"], "rec.distance", f32, (rec_cap,))
            self.expect(rec["accepted"], "rec.accepted", b8, (rec_cap,))
            self.expect(rec["valid"], "rec.valid", b8, (rec_cap,))
            rec_ptrs = [rec[k].data_ptr() for k in
                        ("sumstats", "distance", "accepted", "valid")]
        if record:
            self.expect(logq, "logq", f32, (B,))
            self.expect(rec["theta"], "rec.theta", f32, (rec_cap, d))
            self.expect(rec["logq"], "rec.logq", f32, (rec_cap,))
            record_ptrs = [rec["theta"].data_ptr(), rec["logq"].data_ptr()]
        err = _build.library().pyabc_compact_round(
            B, S, d, accept.data_ptr(), valid.data_ptr(), theta.data_ptr(),
            ss.data_ptr(), dist.data_ptr(), logw.data_ptr(), self.ptr(logq),
            self.ptr(m), self.ptr(ring_valid), n_cap, res["theta"].data_ptr(),
            res["sumstats"].data_ptr(), res["distance"].data_ptr(),
            res["log_weight"].data_ptr(), res["slot"].data_ptr(),
            self.ptr(res.get("m")), rec_cap, *rec_ptrs, *record_ptrs,
            counters.data_ptr(), _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.launches += 1

    def shards(self, accept, valid, theta, ss, dist, logw, res: dict,
               counters: torch.Tensor, table: torch.Tensor, *, n_shards: int,
               max_rounds: int, m: torch.Tensor | None = None,
               x0: torch.Tensor | None = None, p: float = 2.0,
               feat_rows: torch.Tensor | None = None) -> None:
        """K24a, the shard mode (in place): ``res`` the shard-blocked
        reservoir (with ``m`` under K > 1 and ``dfeat`` under an adaptive
        distance, which reads ``x0`` and ``p``, or the rows of ``feat_rows
        (B, F)`` where given), ``counters`` the generation's ``(5,)``,
        ``table`` the ``(n_shards, 4)`` rows."""
        if ("m" in res) != (m is not None):
            raise ValueError(f"{self.name}: a reservoir with an m column "
                             f"and the round's m go together")
        feat = "dfeat" in res
        if feat_rows is not None and not feat:
            raise ValueError(f"{self.name}: given feature rows need a "
                             f"dfeat column")
        if feat and feat_rows is None and x0 is None:
            raise ValueError(f"{self.name}: distance features need x0")
        extra = [t for t in (m, x0, feat_rows) if t is not None]
        if self.on_cpu(accept, valid, theta, ss, dist, logw, counters, table,
                       *res.values(), *extra):
            compact_shards_plain(accept, valid, theta, ss, dist, logw, res,
                                 counters, table, n_shards=n_shards,
                                 max_rounds=max_rounds, m=m, x0=x0, p=p,
                                 feat_rows=feat_rows)
            return
        B, d = theta.shape
        S = ss.shape[1]
        n_cap = res["distance"].shape[0]
        if n_shards <= 0 or B % n_shards or n_cap % n_shards:
            raise ValueError(f"{self.name}: {n_shards} shards must divide "
                             f"B {B} and the reservoir {n_cap}")
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.expect(accept, "accept", b8, (B,))
        self.expect(valid, "valid", b8, (B,))
        self.expect(theta, "theta", f32, (B, d))
        self.expect(ss, "ss", f32, (B, S))
        self.expect(dist, "dist", f32, (B,))
        self.expect(logw, "logw", f32, (B,))
        self.expect(res["theta"], "res.theta", f32, (n_cap, d))
        self.expect(res["sumstats"], "res.sumstats", f32, (n_cap, S))
        self.expect(res["distance"], "res.distance", f32, (n_cap,))
        self.expect(res["log_weight"], "res.log_weight", f32, (n_cap,))
        self.expect(res["slot"], "res.slot", i32, (n_cap,))
        if m is not None:
            self.expect(m, "m", i32, (B,))
            self.expect(res["m"], "res.m", i32, (n_cap,))
        F = S
        if feat_rows is not None:
            F = feat_rows.shape[1] if feat_rows.dim() == 2 else 0
            self.expect(feat_rows, "feat_rows", f32, (B, F))
            self.expect(res["dfeat"], "res.dfeat", f32, (n_cap, F))
        elif feat:
            self.expect(res["dfeat"], "res.dfeat", f32, (n_cap, S))
            self.expect(x0, "x0", f32, (S,))
        self.expect(counters, "counters", i32, (5,))
        self.expect(table, "table", i32, (n_shards, 4))
        err = _build.library().pyabc_compact_shards(
            n_shards, B // n_shards, S, d, accept.data_ptr(),
            valid.data_ptr(), theta.data_ptr(), ss.data_ptr(),
            dist.data_ptr(), logw.data_ptr(), self.ptr(m), n_cap // n_shards,
            res["theta"].data_ptr(), res["sumstats"].data_ptr(),
            res["distance"].data_ptr(), res["log_weight"].data_ptr(),
            res["slot"].data_ptr(), self.ptr(res.get("m")),
            self.ptr(res.get("dfeat")),
            self.ptr(x0 if feat and feat_rows is None else None), float(p),
            self.ptr(feat_rows), F, int(max_rounds), counters.data_ptr(),
            table.data_ptr(),
            _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches["shards"] += 1
        if feat_rows is not None:
            self.mode_launches["given_rows"] += 1


compact_round = CompactRound()
