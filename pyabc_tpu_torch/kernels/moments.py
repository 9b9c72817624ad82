"""K22: the moment fold and the moment finish of the adaptive refit under
segmented early reject.

Counterpart of ``pyabc_tpu/ops/scale_reduce.py::{accumulate_moments,
combine_moments, scale_from_moments}`` as ``pyabc_tpu/inference/util.py``
builds them into the segmented engine (the per-column take of the
resolved lanes) and the generation step; the CUDA kernels are
``csrc/moments.cu`` with the weight update and recompute of
``csrc/weights.cuh`` (K9's, shared). The plain versions are
``ops/scale_reduce.py``'s.

- ``moment_fold(mom, ss, nseg, valid, seg_of, x0, counters, rec_cap=)``
  folds one segmented round into the generation's ``(6, S)`` block, in
  place: slot b counts when it is valid and its slot index in the
  generation, ``counters[ROUNDS] * B + b``, is below ``rec_cap``; column c
  of it counts when its segment ``seg_of[c]`` is among the ``nseg[b]``
  segments the slot simulated (K18's count). The round index stays on the
  device: no host read.
- ``moment_finish(mom, x0, scale_name=, ...)`` turns the block into the
  ``(S,)`` scale, the weights (1/scale, the ``max_weight_ratio`` clip,
  mean-1 normalization) and the distances of ``rows`` under them ->
  (scale, weights, distances or None).

K24d, the shard mode of sharded fused sampling under an adaptive distance
(``accumulate_moments`` per shard in the JAX package's vmapped
``_generation_while``, ``combine_moments`` and the ``dfeat`` recompute,
``util.py:2404-2420, 2672-2700``; counted in ``mode_launches["shards"]``):

- ``moment_fold.shards(mom, ss, valid, x0, counters, table, n_shards=,
  rec_cap=, max_rounds=)`` folds one round into the ``(n, 6, S)`` blocks in
  place, before the round's compaction: shard s, while it runs (its
  accepted count below its quota, its rounds below ``max_rounds``, read
  from the ``(n, 4)`` table on the device), takes the whole rows of its
  valid lanes whose local slot ``rounds * B_loc + b`` is below ``rec_cap``;
- ``moment_finish.shards(mom, x0, feat, scale_name=, ...)`` combines the
  blocks in shard order, finishes the scale and the weights, and
  recomputes each row's distance from its feature row ``|x - x0|^p``
  (K24a's) as ``(sum w^p f)^(1/p)`` -> (scale, weights, distances).
"""
from __future__ import annotations

import numpy as np
import torch

import math

from ..ops.scale_reduce import (MOMENT_ROWS, accumulate_moments,
                                combine_moments, scale_from_moments)
from ..ops.shard import shard_quota
from . import _build
from .base import Kernel
from .pnorm_accept import pnorm_rows
from .scale_reduce import weight_update_plain

#: the moment scale functions, in the order of the kernel's codes
SCALE_NAMES = (
    "mean", "bias", "span", "standard_deviation",
    "root_mean_square_deviation", "mean_absolute_deviation_to_observation",
    "standard_deviation_to_observation",
)
#: index of the round counter and of the target n in the generation's
#: counters vector
ROUNDS, N_TARGET = 1, 4
#: rows of the round a fold block reads at least (pass 1's parts)
ROWS_PER_PART = 1024
MAX_PARTS = 64


def seg_of_columns(imap: np.ndarray | torch.Tensor) -> np.ndarray:
    """The segment of each flat column: the inverse of the emission map
    ``(n_seg, seg_size)`` (the JAX engine's ``dense_pos`` // seg_size)."""
    imap = np.asarray(imap.cpu() if isinstance(imap, torch.Tensor)
                      else imap)
    seg_of = np.full(imap.size, -1, np.int32)
    for j in range(imap.shape[0]):
        seg_of[imap[j]] = j
    if (seg_of < 0).any():
        raise ValueError("the emission map does not cover every column")
    return seg_of


def moment_fold_plain(mom, ss, nseg, valid, seg_of, x0, counters, *,
                      rec_cap: int) -> torch.Tensor:
    """Plain PyTorch version: ``mom`` updated in place (and returned)."""
    B = ss.shape[0]
    slot = counters[ROUNDS].to(torch.int64) * B + torch.arange(
        B, dtype=torch.int64, device=ss.device)
    rows = valid & (slot < rec_cap)
    take = rows[:, None] & (seg_of[None, :].long() < nseg[:, None].long())
    mom.copy_(accumulate_moments(mom, ss, take, x0))
    return mom


def moment_finish_plain(mom, x0, *, scale_name: str,
                        max_weight_ratio: float | None = None,
                        normalize_weights: bool = True, rows=None,
                        p: float = 2.0):
    """Plain PyTorch version -> (scale, weights, distances or None)."""
    scale = scale_from_moments(scale_name)(mom, x0)
    w = weight_update_plain(scale, max_weight_ratio, normalize_weights)
    d = None if rows is None else pnorm_rows(rows, x0, w, p)
    return scale, w, d


def moment_fold_shards_plain(mom, ss, valid, x0, counters, table, *,
                             n_shards: int, rec_cap: int,
                             max_rounds: int) -> torch.Tensor:
    """Plain PyTorch version of the shard fold: ``mom (n, 6, S)`` updated
    in place (and returned)."""
    B_loc = ss.shape[0] // n_shards
    quota = shard_quota(counters[N_TARGET], n_shards)
    for s in range(n_shards):
        if not (int(table[s, 0]) < int(quota[s])
                and int(table[s, 1]) < max_rounds):
            continue
        lanes = slice(s * B_loc, (s + 1) * B_loc)
        slot = int(table[s, 1]) * B_loc + torch.arange(B_loc,
                                                       device=ss.device)
        take = valid[lanes] & (slot < rec_cap)
        mom[s].copy_(accumulate_moments(mom[s], ss[lanes], take, x0))
    return mom


def feature_distances(feat: torch.Tensor, w: torch.Tensor,
                      p: float) -> torch.Tensor:
    """Each row's distance from its features ``|x - x0|^p`` under the
    weights w: ``(sum w^p f)^(1/p)``, ``max w f`` at p = inf (``pyabc_tpu``
    ``device_sharded_dfeat``'s ``combine``)."""
    if math.isinf(p):
        return (w[None, :] * feat).amax(1)
    wp = w * w if p == 2 else (w if p == 1 else w ** p)
    acc = (wp[None, :] * feat).sum(1)
    return acc.sqrt() if p == 2 else (acc if p == 1 else acc ** (1.0 / p))


def moment_finish_shards_plain(mom, x0, feat, *, scale_name: str,
                               max_weight_ratio: float | None = None,
                               normalize_weights: bool = True,
                               p: float = 2.0):
    """Plain PyTorch version of the shard finish -> (scale, weights,
    distances)."""
    scale = scale_from_moments(scale_name)(combine_moments(mom), x0)
    w = weight_update_plain(scale, max_weight_ratio, normalize_weights)
    return scale, w, feature_distances(feat, w, p)


class MomentFold(Kernel):
    name = "moment_fold"
    source = "pyabc_tpu_torch/csrc/moments.cu"
    replaces = "pyabc_tpu/ops/scale_reduce.py:67"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"shards": 0}

    def __call__(self, mom: torch.Tensor, ss: torch.Tensor,
                 nseg: torch.Tensor, valid: torch.Tensor,
                 seg_of: torch.Tensor, x0: torch.Tensor,
                 counters: torch.Tensor, *, rec_cap: int) -> torch.Tensor:
        if self.on_cpu(mom, ss, nseg, valid, seg_of, x0, counters):
            return moment_fold_plain(mom, ss, nseg, valid, seg_of, x0,
                                     counters, rec_cap=rec_cap)
        B, S = ss.shape
        f32 = torch.float32
        self.expect(mom, "mom", f32, (MOMENT_ROWS, S))
        self.expect(ss, "ss", f32, (B, S))
        self.expect(nseg, "nseg", torch.int32, (B,))
        self.expect(valid, "valid", torch.bool, (B,))
        self.expect(seg_of, "seg_of", torch.int32, (S,))
        self.expect(x0, "x0", f32, (S,))
        self.expect(counters, "counters", torch.int32,
                    (counters.shape[0],))
        parts = max(1, min(MAX_PARTS, -(-B // ROWS_PER_PART)))
        part = torch.empty(parts * MOMENT_ROWS * S, dtype=f32,
                           device=ss.device)
        err = _build.library().pyabc_moment_fold(
            mom.data_ptr(), ss.data_ptr(), B, S, nseg.data_ptr(),
            valid.data_ptr(), seg_of.data_ptr(), x0.data_ptr(),
            counters.data_ptr(), int(rec_cap), parts, part.data_ptr(),
            _build.stream_ptr(ss.device))
        _build.check(err, self.name)
        self.launches += 1
        return mom

    def shards(self, mom: torch.Tensor, ss: torch.Tensor,
               valid: torch.Tensor, x0: torch.Tensor, counters: torch.Tensor,
               table: torch.Tensor, *, n_shards: int, rec_cap: int,
               max_rounds: int) -> torch.Tensor:
        """K24d's fold (in place, before the round's compaction)."""
        if self.on_cpu(mom, ss, valid, x0, counters, table):
            return moment_fold_shards_plain(
                mom, ss, valid, x0, counters, table, n_shards=n_shards,
                rec_cap=rec_cap, max_rounds=max_rounds)
        B, S = ss.shape
        if n_shards <= 0 or B % n_shards:
            raise ValueError(f"{self.name}: {n_shards} shards must divide "
                             f"B {B}")
        f32 = torch.float32
        self.expect(mom, "mom", f32, (n_shards, MOMENT_ROWS, S))
        self.expect(ss, "ss", f32, (B, S))
        self.expect(valid, "valid", torch.bool, (B,))
        self.expect(x0, "x0", f32, (S,))
        self.expect(counters, "counters", torch.int32, (5,))
        self.expect(table, "table", torch.int32, (n_shards, 4))
        err = _build.library().pyabc_moment_fold_shards(
            mom.data_ptr(), ss.data_ptr(), n_shards, B // n_shards, S,
            valid.data_ptr(), x0.data_ptr(), counters.data_ptr(),
            table.data_ptr(), int(rec_cap), int(max_rounds),
            _build.stream_ptr(ss.device))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches["shards"] += 1
        return mom


class MomentFinish(Kernel):
    name = "moment_finish"
    source = "pyabc_tpu_torch/csrc/moments.cu"
    replaces = "pyabc_tpu/ops/scale_reduce.py:115"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"shards": 0}

    def __call__(self, mom: torch.Tensor, x0: torch.Tensor, *,
                 scale_name: str, max_weight_ratio: float | None = None,
                 normalize_weights: bool = True, rows=None, p: float = 2.0):
        extra = [] if rows is None else [rows]
        if self.on_cpu(mom, x0, *extra):
            return moment_finish_plain(
                mom, x0, scale_name=scale_name,
                max_weight_ratio=max_weight_ratio,
                normalize_weights=normalize_weights, rows=rows, p=p)
        if scale_name not in SCALE_NAMES:
            raise NotImplementedError(f"{self.name}: {scale_name!r} has no "
                                      f"moment form")
        if max_weight_ratio is not None and not max_weight_ratio > 0:
            raise ValueError(f"{self.name}: max_weight_ratio must be > 0")
        S = x0.shape[0]
        f32 = torch.float32
        self.expect(mom, "mom", f32, (MOMENT_ROWS, S))
        self.expect(x0, "x0", f32, (S,))
        n_rows = 0
        if rows is not None:
            n_rows = rows.shape[0]
            self.expect(rows, "rows", f32, (n_rows, S))
        dev = x0.device
        scale = torch.empty(S, dtype=f32, device=dev)
        w = torch.empty(S, dtype=f32, device=dev)
        d = None if rows is None else torch.empty(n_rows, dtype=f32,
                                                  device=dev)
        err = _build.library().pyabc_moment_finish(
            mom.data_ptr(), S, x0.data_ptr(), SCALE_NAMES.index(scale_name),
            float(max_weight_ratio or 0.0), int(bool(normalize_weights)),
            self.ptr(rows), n_rows, float(p), scale.data_ptr(),
            w.data_ptr(), self.ptr(d), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return scale, w, d

    def shards(self, mom: torch.Tensor, x0: torch.Tensor, feat: torch.Tensor,
               *, scale_name: str, max_weight_ratio: float | None = None,
               normalize_weights: bool = True, p: float = 2.0):
        """K24d's finish: ``mom (n, 6, S)`` combined in shard order, the
        scale and weights, the distances of the ``(rows, S)`` feature rows
        -> (scale, weights, distances)."""
        if self.on_cpu(mom, x0, feat):
            return moment_finish_shards_plain(
                mom, x0, feat, scale_name=scale_name,
                max_weight_ratio=max_weight_ratio,
                normalize_weights=normalize_weights, p=p)
        if scale_name not in SCALE_NAMES:
            raise NotImplementedError(f"{self.name}: {scale_name!r} has no "
                                      f"moment form")
        if max_weight_ratio is not None and not max_weight_ratio > 0:
            raise ValueError(f"{self.name}: max_weight_ratio must be > 0")
        n_shards, S = mom.shape[0], x0.shape[0]
        n_rows = feat.shape[0]
        f32 = torch.float32
        self.expect(mom, "mom", f32, (n_shards, MOMENT_ROWS, S))
        self.expect(x0, "x0", f32, (S,))
        self.expect(feat, "feat", f32, (n_rows, S))
        dev = x0.device
        combined = torch.empty(MOMENT_ROWS, S, dtype=f32, device=dev)
        scale = torch.empty(S, dtype=f32, device=dev)
        w = torch.empty(S, dtype=f32, device=dev)
        d = torch.empty(n_rows, dtype=f32, device=dev)
        err = _build.library().pyabc_moment_finish_shards(
            mom.data_ptr(), n_shards, S, x0.data_ptr(),
            SCALE_NAMES.index(scale_name), float(max_weight_ratio or 0.0),
            int(bool(normalize_weights)), feat.data_ptr(), n_rows, float(p),
            combined.data_ptr(), scale.data_ptr(), w.data_ptr(),
            d.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches["shards"] += 1
        return scale, w, d


moment_fold = MomentFold()
moment_finish = MomentFinish()
