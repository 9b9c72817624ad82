"""K18: the simulator call of one proposal round under segmented early
reject.

Counterpart of ``pyabc_tpu/inference/util.py::DeviceContext.
_generation_while_seg`` with ``ops/segment.py::{select_lanes,
gather_lanes}`` and ``distance/pnorm.py::PNormDistance.device_bound_fn``;
the CUDA kernel is ``csrc/segment_round.cu``, templated on the built-in
segment steps (K19 birth-death, K19 stochastic LV, K20b network SIR, K20b's
segmented ODE family).

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

Two modes (each also counted in ``mode_launches``):

- adaptive (``return_nseg=True``): the call also returns ``nseg (B,)``
  int32, the segments each slot simulated (``n_segments`` for a completed
  slot, the retiring segment + 1 for a retired one), which K22's fold
  (``kernels/moments.py``) reads to take a retired slot's prefix columns;
- K > 1 (``seg`` a sequence of K protocols, ``m (B,)`` the slots' models
  from K2's K > 1 mode): each slot steps with its own model's descriptor,
  an array of K ``SegModel``s of one built-in kind (the uniform protocol
  guarantees one segment count, block size and layout). The plain version
  runs every model on every slot (on its first ``dims[k]`` parameters)
  and keeps each slot's own model's values, as ``lax.switch`` under
  ``vmap``.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import not_ported
from . import _build
from .base import Kernel
from .philox import PhiloxStream
from .tau_leap import MAX_MODELS, SegModelC

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


def _models_of(seg) -> list:
    return list(seg) if isinstance(seg, (list, tuple)) else [seg]


def segment_round_plain(seg, theta, valid, stream: PhiloxStream, *, imap,
                        x0, w, p: float, eps, hist_min=None, width: int,
                        seg_ctr, m=None, dims=None,
                        return_nseg: bool = False):
    """Plain PyTorch version -> (ss ``(B, width)``, keep ``(B,)``[, nseg
    ``(B,)`` int32])."""
    B = theta.shape[0]
    n_seg = imap.shape[0]
    segs = _models_of(seg)
    if len(segs) > 1 and m is None:
        raise ValueError("several segmented models need the slots' m")
    thr = eps if hist_min is None else torch.minimum(eps, hist_min)
    lim = bound_limit(thr, p)
    carries = [s.init(theta if dims is None
                      else theta[:, :dims[k]].contiguous())
               for k, s in enumerate(segs)]
    ss = torch.zeros(B, width, dtype=torch.float32, device=theta.device)
    acc = torch.zeros(B, dtype=torch.float32, device=theta.device)
    retired = torch.zeros(B, dtype=torch.bool, device=theta.device)
    steps = torch.full((B,), n_seg, dtype=torch.int64, device=theta.device)
    for j in range(n_seg):
        vals = None
        for k, s in enumerate(segs):
            carries[k], v = s.step(carries[k], j, stream)
            vals = v if vals is None else torch.where((m == k)[:, None], v,
                                                      vals)
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
    keep = valid & ~retired
    if return_nseg:
        return ss, keep, steps.to(torch.int32)
    return ss, keep


class SegmentRound(Kernel):
    name = "segment_round"
    source = "pyabc_tpu_torch/csrc/segment_round.cu"
    replaces = "pyabc_tpu/inference/util.py:787"

    def __init__(self):
        super().__init__()
        #: launches in the adaptive (nseg) and K > 1 modes
        self.mode_launches = {"adaptive": 0, "k_gt_1": 0}

    def __call__(self, seg, theta: torch.Tensor, valid: torch.Tensor,
                 stream: PhiloxStream, *, imap: torch.Tensor,
                 x0: torch.Tensor, w: torch.Tensor, p: float,
                 eps: torch.Tensor, hist_min: torch.Tensor | None = None,
                 width: int, seg_ctr: torch.Tensor,
                 m: torch.Tensor | None = None, dims=None,
                 return_nseg: bool = False):
        kw = dict(imap=imap, x0=x0, w=w, p=p, eps=eps, hist_min=hist_min,
                  width=width, seg_ctr=seg_ctr, m=m, dims=dims,
                  return_nseg=return_nseg)
        opt = [t for t in (hist_min, m) if t is not None]
        if self.on_cpu(theta, valid, stream.counters, imap, x0, w, eps,
                       seg_ctr, *opt):
            return segment_round_plain(seg, theta, valid, stream, **kw)
        segs = _models_of(seg)
        if any(s.kernel is None for s in segs):
            raise not_ported("early reject for a segmented model without a "
                             "built-in CUDA step on the card", "13")
        specs = [s.kernel[1] for s in segs]
        if len(specs) > MAX_MODELS:
            raise ValueError(f"{self.name}: at most {MAX_MODELS} models")
        if len({s.kind for s in specs}) != 1:
            raise ValueError(f"{self.name}: the models of one round must "
                             f"share one built-in step")
        spec = specs[0]
        B, stride = theta.shape
        f32 = torch.float32
        if len(specs) > 1 or m is not None:
            if m is None:
                raise ValueError(f"{self.name}: several models need m")
            self.expect(m, "m", torch.int32, (B,))
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
        nseg = (torch.empty(B, dtype=torch.int32, device=dev)
                if return_nseg else None)
        next_slot = torch.empty(1, dtype=torch.int32, device=dev)
        models = (SegModelC * MAX_MODELS)(*[s.c_model() for s in specs])
        err = _build.library().pyabc_segment_round(
            ctypes.addressof(models), len(specs), self.ptr(m), threads,
            theta.data_ptr(), stride, valid.data_ptr(), B, imap.data_ptr(),
            x0.data_ptr(), w.data_ptr(), float(p), eps.data_ptr(),
            self.ptr(hist_min), width, ss.data_ptr(), keep.data_ptr(),
            self.ptr(nseg), next_slot.data_ptr(), seg_ctr.data_ptr(),
            *stream.key,
            stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        if return_nseg:
            self.mode_launches["adaptive"] += 1
        if m is not None:
            self.mode_launches["k_gt_1"] += 1
        return (ss, keep, nseg) if return_nseg else (ss, keep)


segment_round = SegmentRound()
