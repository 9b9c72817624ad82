"""Segmented simulation: the protocol of early reject
(``pyabc_tpu/ops/segment.py`` counterpart).

A model may factor its simulator into fixed-length segments, each emitting
a block of its summary statistics. For a p-norm distance the partial sum
over a trajectory prefix lower-bounds the full distance, so a candidate
whose prefix bound already exceeds the generation's threshold is provably
rejected and its remaining segments are wasted work. The segmented round
(K18, ``kernels/segment_round.py``) retires such candidates between
segments; this module holds the protocol and its pure helpers.

:class:`SegmentedSim` in the port:

- ``init(theta (B, dim)) -> carry``: a dict of per-lane tensors;
- ``step(carry, seg, stream) -> (carry, (B, seg_size) float32)``: advance
  every lane of ``carry`` one segment, drawing its noise from the round's
  simulator-noise Philox stream (keyed by the lane, never by the segment);
- ``layout``: per segment, for each named statistic, the next
  ``sizes[name] / n_segments`` entries of its time series;
- ``kernel``: for the built-in simulators, ``(range kernel, spec)``: the
  hand-written kernel that runs a range of segments on the card (K19 tau
  leaping, K20b network SIR) and the spec K18 steps one segment at a time.
  A user's segmented model has none and steps in torch.

:func:`full_sim_from_segments` builds the ordinary simulator from the
chain, so the classic path and the segmented round compute the same
statistics for a candidate that runs to completion.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class SegmentedSim:
    """The segmented-simulation protocol of a ``TorchModel``; ``layout`` is
    a tuple of ``(stat_name, per_segment_length)`` pairs in emission
    order."""

    n_segments: int
    init: Callable
    step: Callable
    layout: tuple
    kernel: tuple | None = None

    @property
    def seg_size(self) -> int:
        return int(sum(per for _name, per in self.layout))


def spec_protocol(spec, layout: tuple, kernel) -> SegmentedSim:
    """The protocol of a built-in simulator ``spec`` (``initial_state``,
    ``lane_params``, ``step``, ``n_seg``) run on the card by ``kernel``."""

    def init(theta: torch.Tensor) -> dict:
        B = theta.shape[0]
        return {"state": spec.initial_state(B, theta.device),
                "params": spec.lane_params(theta),
                "lane": torch.arange(B, dtype=torch.int64,
                                     device=theta.device)}

    def step(carry: dict, seg: int, stream):
        # the lanes' global numbers: a mesh rank's block starts at lane0 (a
        # noiseless step may be given no stream)
        lane0 = 0 if stream is None else stream.lane0
        state, vals = spec.step(carry["state"], carry["params"], seg, stream,
                                lane0 + carry["lane"])
        return {**carry, "state": state}, vals

    return SegmentedSim(n_segments=spec.n_seg, init=init, step=step,
                        layout=layout, kernel=(kernel, spec))


def index_map_for(seg: SegmentedSim, spec) -> np.ndarray:
    """``(n_segments, seg_size)`` int32 map from each segment's emitted block
    to its positions in the spec's FLAT sum-stat vector (stats concatenated
    by sorted name, so a channel's series is not contiguous in emission
    order)."""
    rows = []
    for j in range(seg.n_segments):
        cols = []
        for name, per in seg.layout:
            if name not in spec.offsets:
                raise KeyError(
                    f"segment layout names unknown stat {name!r} "
                    f"(spec has {spec.names})")
            if per * seg.n_segments != spec.sizes[name]:
                raise ValueError(
                    f"stat {name!r}: {seg.n_segments} segments x {per} "
                    f"per segment != spec size {spec.sizes[name]}")
            off = spec.offsets[name] + j * per
            cols.append(np.arange(off, off + per))
        rows.append(np.concatenate(cols))
    out = np.stack(rows).astype(np.int32)
    if out.shape != (seg.n_segments, seg.seg_size):
        raise ValueError("segment layout does not tile the spec")
    return out


def run_segments(seg: SegmentedSim, theta: torch.Tensor, stream
                 ) -> torch.Tensor:
    """The whole chain in torch -> ``(B, n_segments, seg_size)``."""
    carry = seg.init(theta)
    out = []
    for j in range(seg.n_segments):
        carry, vals = seg.step(carry, j, stream)
        out.append(vals)
    return torch.stack(out, dim=1)


def full_sim_from_segments(seg: SegmentedSim) -> Callable:
    """The ordinary dict simulator ``sim(theta, generator)`` of the chain
    (its noise on a stream keyed by the generator, as built-in models draw
    outside the rounds)."""
    from ..kernels.philox import generator_stream

    def sim(theta: torch.Tensor, generator: torch.Generator) -> dict:
        stream = generator_stream(generator, theta.device)
        if seg.kernel is not None:
            kern, kspec = seg.kernel
            out, _ = kern(kspec, theta.contiguous(), stream)
            out = out.reshape(theta.shape[0], seg.n_segments, seg.seg_size)
        else:
            out = run_segments(seg, theta, stream)
        res, col = {}, 0
        for name, per in seg.layout:
            res[name] = out[:, :, col:col + per].reshape(theta.shape[0], -1)
            col += per
        return res

    return sim


def simulate_segments_flat(seg: SegmentedSim, theta: torch.Tensor,
                           imap: torch.Tensor, width: int, stream
                           ) -> torch.Tensor:
    """The classic path of a segmented model: every segment of every lane
    -> ``(B, width)`` rows in flat sum-stat order (``imap`` from
    :func:`index_map_for` on the rows' device). A built-in model runs its
    range kernel once over all segments."""
    if seg.kernel is not None:
        kern, kspec = seg.kernel
        out, _ = kern(kspec, theta.contiguous(), stream, colmap=imap,
                      width=width)
        return out
    vals = run_segments(seg, theta, stream)
    out = torch.zeros(theta.shape[0], width, dtype=torch.float32,
                      device=theta.device)
    out[:, imap.long().reshape(-1)] = vals.reshape(theta.shape[0], -1)
    return out


def uniform_protocol_reason(models) -> str | None:
    """Why a model family cannot run one segmented round (None = it can):
    every model must declare the protocol with the same segment count,
    block size and layout."""
    segs = [getattr(m, "segmented", None) for m in models]
    if any(s is None for s in segs):
        missing = [m.name for m, s in zip(models, segs) if s is None]
        return (f"model(s) {missing} declare no segmented-simulation "
                f"protocol (TorchModel(segmented=...))")
    ref = segs[0]
    if ref.n_segments < 2:
        return "n_segments < 2 leaves nothing to retire early"
    for m, s in zip(models[1:], segs[1:]):
        if s.n_segments != ref.n_segments or s.seg_size != ref.seg_size:
            return (f"model {m.name!r} segments "
                    f"({s.n_segments}x{s.seg_size}) differ from "
                    f"{models[0].name!r} ({ref.n_segments}x{ref.seg_size})")
        if tuple(s.layout) != tuple(ref.layout):
            return (f"model {m.name!r} emit layout differs from "
                    f"{models[0].name!r}")
    return None


def occupancy(seg_steps, lane_slots):
    """Share of the lane-segment slots the engine executed that advanced a
    live candidate (1.0 = no lane idle); ``lane_slots`` is K18's count
    (32 x the segments of each warp's busiest thread) or, for the plain
    version, every segment of every slot."""
    return np.where(lane_slots > 0, seg_steps / np.maximum(lane_slots, 1),
                    1.0)
