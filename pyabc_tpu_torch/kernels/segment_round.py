"""K18: the simulator call of one proposal round under segmented early
reject.

Counterpart of ``pyabc_tpu/inference/util.py::DeviceContext.
_generation_while_seg`` with ``ops/segment.py::{select_lanes,
gather_lanes}`` and ``distance/pnorm.py::PNormDistance.device_bound_fn``;
the CUDA kernel is ``csrc/segment_round.cu``, templated on the built-in
segment steps (K19 birth-death, K19 stochastic LV, K20b network SIR).

K2 and K3 propose a round's B slots as in a classic round; this call takes
the simulator's place. Each slot is stepped segment by segment, its
statistics written to ``ss[slot, index_map[seg]]`` and folded into the
p-norm's prefix bound; after a segment that is not the last the slot
retires when its proposal is invalid or its bound exceeds the threshold
with the 1e-4 slack (``PNormDistance.BOUND_RTOL``). It returns ``(ss,
keep)``: ``keep`` is True for a valid slot that ran every segment, and is
the valid mask K5 tests on, so retired slots are rejected and complete ones
get the exact test on their full statistics. ``seg_ctr`` (int64 ``(4,)``,
accumulated in place over a generation): slots retired, segments stepped,
slots resolved, lane-segment slots executed.

The kernel runs fewer threads than slots; a thread whose slot retires or
completes takes the next slot from a device counter, so the work a
retirement frees goes to another candidate. The plain version runs every
segment of every slot with the plain step and marks a slot retired at the
first segment where it would retire: the same statistics for kept slots,
the same ``keep`` and the same first three counters; its lane-segment
slots are all ``B * n_segments`` it ran.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import not_ported
from . import _build
from .base import Kernel
from .philox import PhiloxStream

#: relative slack of the retirement test (pnorm.py's BOUND_RTOL)
BOUND_RTOL = 1e-4
#: threads K18 runs per SM (fewer threads than slots: a freed thread takes
#: the next slot)
THREADS_PER_SM = 512
#: SEG_CTR layout
RETIRED, SEG_STEPS, RESOLVED, LANE_SLOTS = range(4)


def bound_limit(thr: torch.Tensor, p: float) -> torch.Tensor:
    """The bound a slot must exceed: ``(thr (1 + rtol))^p`` (``thr (1 +
    rtol)`` at p = 1 and p = inf)."""
    t = thr * (1.0 + BOUND_RTOL)
    if p == 2.0:
        return t * t
    if p == 1.0 or p == float("inf"):
        return t
    return torch.pow(t, p)


def bound_fold(acc, vals, x0, w, p: float) -> torch.Tensor:
    """Fold one segment's values ``(B, seg_size)`` (x0, w: that segment's
    columns) into the prefix bound ``acc`` in emission order: the sum of
    ``(w |v - x0|)^p`` over the block, then added (p = inf: the running
    max, NaN kept)."""
    d = w * (vals - x0).abs()
    if p == float("inf"):
        for k in range(d.shape[1]):
            acc = torch.maximum(acc, d[:, k])
        return acc
    s = torch.zeros_like(acc)
    for k in range(d.shape[1]):
        dk = d[:, k]
        s = s + (dk if p == 1.0 else dk * dk if p == 2.0
                 else torch.pow(dk, p))
    return acc + s


def segment_round_plain(seg, theta, valid, stream: PhiloxStream, *, imap,
                        x0, w, p: float, eps, hist_min=None, width: int,
                        seg_ctr):
    """Plain PyTorch version -> (ss ``(B, width)``, keep ``(B,)``)."""
    B = theta.shape[0]
    n_seg = imap.shape[0]
    thr = eps if hist_min is None else torch.minimum(eps, hist_min)
    lim = bound_limit(thr, p)
    carry = seg.init(theta)
    ss = torch.zeros(B, width, dtype=torch.float32, device=theta.device)
    acc = torch.zeros(B, dtype=torch.float32, device=theta.device)
    retired = torch.zeros(B, dtype=torch.bool, device=theta.device)
    steps = torch.full((B,), n_seg, dtype=torch.int64, device=theta.device)
    for j in range(n_seg):
        carry, vals = seg.step(carry, j, stream)
        cols = imap[j].long()
        ss[:, cols] = vals
        acc = bound_fold(acc, vals, x0[cols], w[cols], p)
        if j < n_seg - 1:
            now = ~retired & (~valid | (acc > lim))
            steps = torch.where(now, j + 1, steps)
            retired = retired | now
    seg_ctr[RETIRED] += retired.sum()
    seg_ctr[SEG_STEPS] += steps.sum()
    seg_ctr[RESOLVED] += B
    seg_ctr[LANE_SLOTS] += B * n_seg
    return ss, valid & ~retired


class SegmentRound(Kernel):
    name = "segment_round"
    source = "pyabc_tpu_torch/csrc/segment_round.cu"
    replaces = "pyabc_tpu/inference/util.py:787"

    def __call__(self, seg, theta: torch.Tensor, valid: torch.Tensor,
                 stream: PhiloxStream, *, imap: torch.Tensor,
                 x0: torch.Tensor, w: torch.Tensor, p: float,
                 eps: torch.Tensor, hist_min: torch.Tensor | None = None,
                 width: int, seg_ctr: torch.Tensor):
        kw = dict(imap=imap, x0=x0, w=w, p=p, eps=eps, hist_min=hist_min,
                  width=width, seg_ctr=seg_ctr)
        opt = [hist_min] if hist_min is not None else []
        if self.on_cpu(theta, valid, stream.counters, imap, x0, w, eps,
                       seg_ctr, *opt):
            return segment_round_plain(seg, theta, valid, stream, **kw)
        if seg.kernel is None:
            raise not_ported("early reject for a segmented model without a "
                             "built-in CUDA step on the card", "13")
        spec = seg.kernel[1]
        B, stride = theta.shape
        f32 = torch.float32
        self.expect(theta, "theta", f32, (B, stride))
        self.expect(valid, "valid", torch.bool, (B,))
        self.expect(imap, "imap", torch.int32, (spec.n_seg, spec.seg_size))
        self.expect(x0, "x0", f32, (width,))
        self.expect(w, "w", f32, (width,))
        self.expect(eps, "eps", f32, ())
        if hist_min is not None:
            self.expect(hist_min, "hist_min", f32, ())
        self.expect(seg_ctr, "seg_ctr", torch.int64, (4,))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        dev = theta.device
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        threads = min(-(-B // 128) * 128, sms * THREADS_PER_SM)
        ss = torch.empty(B, width, dtype=f32, device=dev)
        keep = torch.empty(B, dtype=torch.bool, device=dev)
        next_slot = torch.empty(1, dtype=torch.int32, device=dev)
        model = spec.c_model()
        err = _build.library().pyabc_segment_round(
            ctypes.addressof(model), threads, theta.data_ptr(), stride,
            valid.data_ptr(), B, imap.data_ptr(), x0.data_ptr(),
            w.data_ptr(), float(p), eps.data_ptr(), self.ptr(hist_min),
            width, ss.data_ptr(), keep.data_ptr(), next_slot.data_ptr(),
            seg_ctr.data_ptr(), *stream.key, stream.generation, stream.tag,
            stream.max_rounds, stream.counters.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return ss, keep


segment_round = SegmentRound()
