"""K19: Poisson tau leaping of one proposal round, over a range of segments.

Counterpart of ``pyabc_tpu/models/gillespie.py::tau_leap`` and
``tau_leap_segmented`` under ``vmap`` for the two built-in reaction
networks (birth-death, stochastic Lotka-Volterra); the CUDA kernel is
``csrc/tau_leap.cu`` with the step in ``csrc/tau_leap.cuh``, and K18
(``segment_round``) runs the same step one segment at a time.

Entry: ``(carry, theta, seg_from, seg_to)`` -> the statistics of those
segments. The carry is the state ``x`` ``(B, n_species)`` (None: the
initial counts); emitted value k of segment j goes to column ``colmap[j -
seg_from, k]`` of a ``(B, width)`` output, so the classic path writes the
row in flat sum-stat order in one launch.

The Poisson counts come from ``philox.poisson_plain`` / ``philox.cuh::
poisson`` on the simulator-noise stream, draw number ``leap * n_channels +
channel`` of the lane: keyed by the slot, the leap and the channel, never
by the segment. So the segmented and the unsegmented constructors give the
same numbers (a declared difference: JAX keys the two with ``fold_in`` and
``split``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable

import torch

from . import _build
from .base import Kernel
from .philox import POISSON_MAX_DRAWS, PhiloxStream, poisson_plain

#: SegModel.kind of the built-in segmented simulators (csrc/seg_model.cuh)
BIRTH_DEATH, STOCHASTIC_LV, NETWORK_SIR, ODE_FAMILY = 0, 1, 2, 3
#: models one segmented launch takes (csrc/seg_model.cuh's kMaxModels)
MAX_MODELS = 8


class SegModelC(ctypes.Structure):
    """``csrc/seg_model.cuh::SegModel``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "kind", "midpoint", "n_seg", "seg_size", "leaps_per_seg",
        "save_every", "obs_per_seg", "n_sub", "variant")] + [
        (n, ctypes.c_float) for n in (
            "tau", "half_tau", "x0_0", "x0_1", "dt", "h2", "h6", "n_pop",
            "c_self", "c_half", "seed_i", "noise_sd")]


def relu_keep_nan(v: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(v, 0)``: NaN stays NaN."""
    return torch.where(torch.isnan(v), v, torch.clamp_min(v, 0.0))


def channel_sum(vals, stoich, s: int) -> torch.Tensor:
    """sum_c vals[c] * stoich[c][s] in channel order from 0, every term
    included (as the kernel sums)."""
    acc = torch.zeros_like(vals[0])
    for c, v in enumerate(vals):
        acc = acc + v * float(stoich[c][s])
    return acc


def tau_leap_leaps(x, rates, prop: Callable, stoich, *, tau: float,
                   midpoint: bool, stream: PhiloxStream,
                   lanes: torch.Tensor, first_leap: int, n_leaps: int,
                   save_every: int) -> tuple[torch.Tensor, list]:
    """``n_leaps`` leaps of every lane from state ``x`` ``(B, n_species)``
    -> (the new state, the states after every ``save_every``-th leap).
    ``prop(x, rates)`` returns the ``n_channels`` propensity columns."""
    n_ch, n_sp = len(stoich), len(stoich[0])
    if (first_leap + n_leaps) * n_ch > POISSON_MAX_DRAWS:
        raise ValueError(f"{first_leap + n_leaps} leaps x {n_ch} channels "
                         f"exceed the {POISSON_MAX_DRAWS} draws of a lane")
    half_tau = 0.5 * tau
    draws = torch.arange(n_ch, dtype=torch.int64, device=x.device)
    saved = []
    for i in range(n_leaps):
        a = [relu_keep_nan(v) for v in prop(x, rates)]
        if midpoint:
            xm = torch.stack([relu_keep_nan(
                x[:, s] + channel_sum([half_tau * v for v in a], stoich, s))
                for s in range(n_sp)], dim=1)
            a = [relu_keep_nan(v) for v in prop(xm, rates)]
        lam = torch.stack([v * tau for v in a], dim=1)
        n = poisson_plain(stream, lanes[:, None],
                          (first_leap + i) * n_ch + draws[None, :], lam)
        x = torch.stack([relu_keep_nan(
            x[:, s] + channel_sum(n.unbind(1), stoich, s))
            for s in range(n_sp)], dim=1)
        if (i + 1) % save_every == 0:
            saved.append(x)
    return x, saved


@dataclass(frozen=True)
class TauLeapSpec:
    """A built-in reaction network cut into segments: what K19 and K18 need
    to step it on the card and what its plain step needs on the CPU."""

    kind: int
    x0: tuple
    stoich: tuple
    #: (statistic name, species index) in emission order
    channels: tuple
    t1: float
    n_leaps: int
    n_obs: int
    n_seg: int
    midpoint: bool = False

    @property
    def tau(self) -> float:
        return self.t1 / self.n_leaps

    @property
    def save_every(self) -> int:
        return self.n_leaps // self.n_obs

    @property
    def leaps_per_seg(self) -> int:
        return self.n_leaps // self.n_seg

    @property
    def obs_per_seg(self) -> int:
        return self.n_obs // self.n_seg

    @property
    def seg_size(self) -> int:
        return self.obs_per_seg * len(self.channels)

    @property
    def n_species(self) -> int:
        return len(self.x0)

    @property
    def n_rates(self) -> int:
        return len(self.stoich)

    def rates(self, theta: torch.Tensor) -> torch.Tensor:
        """``10 ** theta`` of the rate columns, one rounding (powf)."""
        ten = torch.tensor(10.0, dtype=torch.float32, device=theta.device)
        return torch.pow(ten, theta[:, :self.n_rates])

    lane_params = rates

    def prop(self, x: torch.Tensor, r: torch.Tensor) -> list:
        """Propensity columns in the kernel's operation order."""
        if self.kind == BIRTH_DEATH:
            return [r[:, 0], r[:, 1] * x[:, 0]]
        prey, pred = x[:, 0], x[:, 1]
        return [r[:, 0] * prey, (r[:, 1] * prey) * pred, r[:, 2] * pred]

    def initial_state(self, B: int, device) -> torch.Tensor:
        return torch.tensor(self.x0, dtype=torch.float32,
                            device=device).expand(B, self.n_species).clone()

    def step(self, x, rates, seg: int, stream: PhiloxStream,
             lanes: torch.Tensor):
        """One segment of every lane -> (state, values ``(B, seg_size)``
        in emission order)."""
        x, saved = tau_leap_leaps(
            x, rates, self.prop, self.stoich, tau=self.tau,
            midpoint=self.midpoint, stream=stream, lanes=lanes,
            first_leap=seg * self.leaps_per_seg,
            n_leaps=self.leaps_per_seg, save_every=self.save_every)
        vals = torch.cat([torch.stack([s[:, si] for s in saved], dim=1)
                          for _name, si in self.channels], dim=1)
        return x, vals

    def c_model(self) -> SegModelC:
        x0 = list(self.x0) + [0.0]
        return SegModelC(
            kind=self.kind, midpoint=int(self.midpoint), n_seg=self.n_seg,
            seg_size=self.seg_size, leaps_per_seg=self.leaps_per_seg,
            save_every=self.save_every, obs_per_seg=self.obs_per_seg,
            n_sub=0, tau=self.tau, half_tau=0.5 * self.tau, x0_0=x0[0],
            x0_1=x0[self.n_species - 1])


def default_colmap(seg_size: int, seg_from: int, seg_to: int,
                   device) -> torch.Tensor:
    """Emission order itself: column (j - seg_from) * seg_size + k."""
    return torch.arange((seg_to - seg_from) * seg_size, dtype=torch.int32,
                        device=device).reshape(seg_to - seg_from, seg_size)


def segments_plain(spec, theta: torch.Tensor, stream: PhiloxStream, *,
                   state=None, seg_from: int = 0, seg_to: int | None = None,
                   colmap: torch.Tensor | None = None,
                   width: int | None = None):
    """The plain range entry shared by K19 and K20b network: ``spec``'s
    ``step`` over segments ``seg_from .. seg_to - 1`` -> (out ``(B,
    width)``, the final state)."""
    B = theta.shape[0]
    seg_to = spec.n_seg if seg_to is None else seg_to
    if colmap is None:
        colmap = default_colmap(spec.seg_size, seg_from, seg_to,
                                theta.device)
    width = colmap.numel() if width is None else width
    lanes = torch.arange(B, dtype=torch.int64, device=theta.device)
    state = spec.initial_state(B, theta.device) if state is None else state
    params = spec.lane_params(theta)
    out = torch.zeros(B, width, dtype=torch.float32, device=theta.device)
    for seg in range(seg_from, seg_to):
        state, vals = spec.step(state, params, seg, stream, lanes)
        out[:, colmap[seg - seg_from].long()] = vals
    return out, state


def tau_leap_plain(spec: TauLeapSpec, theta: torch.Tensor,
                   stream: PhiloxStream, **kw):
    """Plain PyTorch version of K19 -> (out, final state)."""
    return segments_plain(spec, theta, stream, **kw)


class RangeKernel(Kernel):
    """The range entry of a built-in segmented simulator on the card."""

    #: the C entry point
    entry: str = ""

    @staticmethod
    def state_width(spec) -> int:
        raise NotImplementedError

    def plain(self, spec, theta, stream, **kw):
        raise NotImplementedError

    def __call__(self, spec, theta: torch.Tensor, stream: PhiloxStream, *,
                 state: torch.Tensor | None = None, seg_from: int = 0,
                 seg_to: int | None = None,
                 colmap: torch.Tensor | None = None,
                 width: int | None = None, return_state: bool = False):
        seg_to = spec.n_seg if seg_to is None else seg_to
        kw = dict(state=state, seg_from=seg_from, seg_to=seg_to,
                  colmap=colmap, width=width)
        opt = [t for t in (state, colmap) if t is not None]
        if self.on_cpu(theta, stream.counters, *opt):
            return self.plain(spec, theta, stream, **kw)
        B, stride = theta.shape
        dev = theta.device
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        n = seg_to - seg_from
        if colmap is None:
            colmap = default_colmap(spec.seg_size, seg_from, seg_to, dev)
        self.expect(colmap, "colmap", torch.int32, (n, spec.seg_size))
        width = colmap.numel() if width is None else int(width)
        sw = self.state_width(spec)
        if state is not None:
            self.expect(state, "state", torch.float32,
                        (B,) + tuple(state.shape[1:]))
            if state[0].numel() != sw:
                raise ValueError(f"{self.name}: state rows hold {sw} floats")
        out = torch.empty(B, width, dtype=torch.float32, device=dev)
        x_out = (torch.empty(B, sw, dtype=torch.float32, device=dev)
                 if return_state else None)
        model = spec.c_model()
        err = getattr(_build.library(), self.entry)(
            ctypes.addressof(model), theta.data_ptr(), B, stride,
            self.ptr(state), self.ptr(x_out), seg_from, seg_to,
            colmap.data_ptr(), width, out.data_ptr(), *stream.key,
            stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out, x_out


class TauLeap(RangeKernel):
    name = "tau_leap"
    source = "pyabc_tpu_torch/csrc/tau_leap.cu"
    replaces = "pyabc_tpu/models/gillespie.py:35"
    entry = "pyabc_tau_leap"

    @staticmethod
    def state_width(spec) -> int:
        return spec.n_species

    def plain(self, spec, theta, stream, **kw):
        return tau_leap_plain(spec, theta, stream, **kw)


tau_leap = TauLeap()
