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

Four modes (each also counted in ``mode_launches``):

- aggregate (``agg`` the sub-distances' p's, ``w`` K25's flat params
  ``[W (n), w_1 (S), ..., w_n (S)]``, ``aggregate.py:85``): each slot
  keeps n prefix bounds, each folded as the p-norm's (``bound_fold``), and
  retires once ``sum_k W_k acc_k^(1/p_k)`` (``agg_total``, k in order)
  exceeds ``thr (1 + 1e-4)``;

- stochastic (``noise`` the ``device_bound_fn`` dict of a noise kernel,
  ``pdf_norm`` the norm, ``accept`` the round's ACCEPT stream; K = 1):
  ``w`` holds the kernel's per-column parameters and ``eps`` the
  temperature T. Each slot starts its accumulator at the family's start
  value and folds each emitted segment in emission order
  (``kernel_accept.noise_bound_fold``, the upper bound of
  ``csrc/noise.cuh``); it retires when the accumulator falls below
  ``thr_s - (1e-3 + 1e-4 |acc|)`` with ``thr_s = pdf_norm + T log(u_s)``,
  ``u_s`` the uniform K21a/K21c draws for that row on ``accept``. At T =
  +inf no slot retires;

- transformed (``lin`` the ``{"At", "proj"}`` of ``kernels/linear_bound.py``
  for a fitted linear learned statistic, p = 2, K = 1; ``w`` unread):
  each slot folds the partial transformed difference ``v`` (``C'``
  floats, ``lin_bound_fold``: a segment's ``(v_k - x0[c_k]) At[c_k]`` in
  emission order, then added) and retires once ``v^T P_j v`` (``j`` the
  segments folded, ``lin_exceeds``) exceeds ``(thr (1 + 1e-4))^2``;

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
from .aggregate import MAX_SUB, p_codes
from .base import Kernel
from .kernel_accept import (BOUND_FAMILIES, FAMILY_CODES, accept_uniforms,
                            noise_bound_fold, upper_exceeds)
from .philox import PhiloxStream, no_lane_base
from .tau_leap import MAX_MODELS, SegModelC

#: relative slack of the retirement test (pnorm.py's BOUND_RTOL)
BOUND_RTOL = 1e-4
#: threads K18 runs per SM (fewer threads than slots: a freed thread takes
#: the next slot)
THREADS_PER_SM = 512
#: the widest learned feature vector the transformed mode folds
MAX_LIN = 8
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


def agg_total(acc, W, ps) -> torch.Tensor:
    """``sum_k W_k acc_k^(1/p_k)`` of the aggregate's prefix bounds ``acc
    (B, n)``, in the order k = 0..n-1 (sqrt at p = 2), as K18 sums it."""
    total = torch.zeros_like(acc[:, 0])
    for k, p in enumerate(ps):
        a = acc[:, k]
        r = (torch.sqrt(a) if p == 2.0 else a
             if p == 1.0 or p == float("inf") else torch.pow(a, 1.0 / p))
        total = total + W[k] * r
    return total


def lin_bound_fold(acc, vals, x0, At) -> torch.Tensor:
    """Fold one segment's values ``(B, k)`` (``x0`` ``(k,)`` and ``At``
    ``(k, C')``: that segment's columns) into the partial transformed
    difference ``acc`` ``(B, C')``: per feature the sum over the block in
    order, then added, as K18's LinBound."""
    contrib = torch.zeros_like(acc)
    for k in range(vals.shape[1]):
        diff = vals[:, k] - x0[k]
        contrib = contrib + diff[:, None] * At[k][None, :]
    return acc + contrib


def lin_exceeds(acc, P, lim) -> torch.Tensor:
    """``v^T P v > lim`` per slot, the sums in K18's order (``P`` the
    ``(C', C')`` projector after the segments folded)."""
    C = acc.shape[1]
    q = torch.zeros_like(acc[:, 0])
    for a in range(C):
        pv = torch.zeros_like(q)
        for b in range(C):
            pv = pv + P[a, b] * acc[:, b]
        q = q + acc[:, a] * pv
    return q > lim


def noise_thresholds(temp, pdf_norm, accept: PhiloxStream,
                     B: int) -> torch.Tensor:
    """Each slot's log-density threshold ``pdf_norm + T log(u_s)``; -inf
    (never retire) at T = +inf or u_s = 0."""
    u = accept_uniforms(accept, B)
    thr = pdf_norm + temp * torch.log(u)
    never = ~torch.isfinite(temp) | (u == 0)
    return torch.where(never, torch.full_like(thr, -float("inf")), thr)


def _models_of(seg) -> list:
    return list(seg) if isinstance(seg, (list, tuple)) else [seg]


def segment_round_plain(seg, theta, valid, stream: PhiloxStream, *, imap,
                        x0, w, p: float, eps, hist_min=None, width: int,
                        seg_ctr, m=None, dims=None,
                        return_nseg: bool = False, noise=None,
                        pdf_norm=None, accept: PhiloxStream | None = None,
                        agg=None, lin=None):
    """Plain PyTorch version -> (ss ``(B, width)``, keep ``(B,)``[, nseg
    ``(B,)`` int32])."""
    B = theta.shape[0]
    n_seg = imap.shape[0]
    segs = _models_of(seg)
    if len(segs) > 1 and m is None:
        raise ValueError("several segmented models need the slots' m")
    if noise is not None:
        family = noise["family"]
        thr = noise_thresholds(eps, pdf_norm, accept, B)
        acc = torch.full((B,), noise["init_value"], dtype=torch.float32,
                         device=theta.device)
    else:
        thr = eps if hist_min is None else torch.minimum(eps, hist_min)
        lim = bound_limit(thr, 1.0 if agg is not None else p)
        acc = torch.zeros(B, dtype=torch.float32, device=theta.device)
    if agg is not None:
        n_sub = len(agg)
        W, subw = w[:n_sub], w[n_sub:].reshape(n_sub, width)
        acc = torch.zeros(B, n_sub, dtype=torch.float32, device=theta.device)
    if lin is not None:
        lim = bound_limit(thr, 2.0)
        acc = torch.zeros(B, lin["At"].shape[1], dtype=torch.float32,
                          device=theta.device)
    carries = [s.init(theta if dims is None
                      else theta[:, :dims[k]].contiguous())
               for k, s in enumerate(segs)]
    ss = torch.zeros(B, width, dtype=torch.float32, device=theta.device)
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
        if noise is not None:
            acc = noise_bound_fold(family, acc, vals, x0[cols], w[cols])
            exceeds = upper_exceeds(acc, thr)
        elif lin is not None:
            acc = lin_bound_fold(acc, vals, x0[cols], lin["At"][cols])
            exceeds = lin_exceeds(acc, lin["proj"][min(j + 1, n_seg)], lim)
        elif agg is not None:
            acc = torch.stack([bound_fold(acc[:, k], vals, x0[cols],
                                          subw[k][cols], pk)
                               for k, pk in enumerate(agg)], 1)
            exceeds = agg_total(acc, W, agg) > lim
        else:
            acc = bound_fold(acc, vals, x0[cols], w[cols], p)
            exceeds = acc > lim
        if j < n_seg - 1:
            now = ~retired & (~valid | exceeds)
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
        self.mode_launches = {"adaptive": 0, "k_gt_1": 0, "stochastic": 0,
                              "aggregate": 0, "linear": 0}

    def __call__(self, seg, theta: torch.Tensor, valid: torch.Tensor,
                 stream: PhiloxStream, *, imap: torch.Tensor,
                 x0: torch.Tensor, w: torch.Tensor, p: float,
                 eps: torch.Tensor, hist_min: torch.Tensor | None = None,
                 width: int, seg_ctr: torch.Tensor,
                 m: torch.Tensor | None = None, dims=None,
                 return_nseg: bool = False, noise: dict | None = None,
                 pdf_norm: torch.Tensor | None = None,
                 accept: PhiloxStream | None = None, agg=None,
                 lin: dict | None = None):
        no_lane_base(stream, self.name)
        kw = dict(imap=imap, x0=x0, w=w, p=p, eps=eps, hist_min=hist_min,
                  width=width, seg_ctr=seg_ctr, m=m, dims=dims,
                  return_nseg=return_nseg, noise=noise, pdf_norm=pdf_norm,
                  accept=accept, agg=agg, lin=lin)
        if lin is not None and (noise is not None or agg is not None
                                or m is not None or p != 2.0):
            raise ValueError(f"{self.name}: the transformed mode takes one "
                             f"model, p = 2 and no other bound")
        if agg is not None and (noise is not None
                                or not 0 < len(agg) <= MAX_SUB):
            raise ValueError(f"{self.name}: the aggregate mode takes 1 to "
                             f"{MAX_SUB} sub-distances and no noise bound")
        if noise is not None:
            if noise["family"] not in BOUND_FAMILIES:
                raise ValueError(f"{self.name}: no upper bound for the "
                                 f"{noise['family']} noise family")
            if pdf_norm is None or accept is None or m is not None \
                    or hist_min is not None:
                raise ValueError(f"{self.name}: the stochastic mode takes "
                                 f"pdf_norm and the accept stream, one "
                                 f"model and no hist_min")
        opt = [t for t in (hist_min, m, pdf_norm) if t is not None]
        if lin is not None:
            opt += [lin["At"], lin["proj"]]
        if accept is not None:
            opt.append(accept.counters)
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
        n_sub = 0 if agg is None else len(agg)
        lin_c = 0
        if lin is not None:
            lin_c = lin["At"].shape[1]
            if not 0 < lin_c <= MAX_LIN:
                raise ValueError(f"{self.name}: the transformed mode takes "
                                 f"at most {MAX_LIN} features")
            self.expect(lin["At"], "At", f32, (width, lin_c))
            self.expect(lin["proj"], "proj", f32,
                        (spec.n_seg + 1, lin_c, lin_c))
            w = lin["At"]
        else:
            self.expect(w, "w", f32, (n_sub * (width + 1) if agg is not None
                                      else width,))
        self.expect(eps, "eps", f32, ())
        if noise is not None:
            self.expect(pdf_norm, "pdf_norm", f32, ())
            if (accept.counters is not stream.counters
                    or accept.max_rounds != stream.max_rounds):
                raise ValueError(f"{self.name}: the accept stream must read "
                                 f"the round's counters and round budget")
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
            stream.counters.data_ptr(),
            -1 if noise is None else FAMILY_CODES[noise["family"]],
            0.0 if noise is None else float(noise["init_value"]),
            self.ptr(pdf_norm),
            *(accept.key if noise is not None else (0, 0)),
            accept.generation if noise is not None else 0,
            accept.tag if noise is not None else 0, n_sub,
            *p_codes(agg or ()), lin_c,
            self.ptr(lin["proj"] if lin is not None else None),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        if return_nseg:
            self.mode_launches["adaptive"] += 1
        if m is not None:
            self.mode_launches["k_gt_1"] += 1
        if noise is not None:
            self.mode_launches["stochastic"] += 1
        if agg is not None:
            self.mode_launches["aggregate"] += 1
        if lin is not None:
            self.mode_launches["linear"] += 1
        return (ss, keep, nseg) if return_nseg else (ss, keep)


segment_round = SegmentRound()
