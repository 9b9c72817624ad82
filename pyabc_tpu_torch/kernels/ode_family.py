"""K20b: the K = 3 ODE family of model selection over one proposal round.

Counterpart of ``pyabc_tpu/models/model_selection.py::ode_family`` (the
unsegmented simulators, ``models/ode.py::rk4_at_times``) switched per lane
over the model index; the CUDA kernel is ``csrc/ode_family_rk4.cu``. Lane
b integrates model ``m[b]``: decay ``(-a) y``, decay + production
``(-a) y + b`` or logistic ``(a y)(1 - y / k)``, from y0 = 2, and returns
y at the ``n_obs`` times, ``(B, n_obs)``. With ``noise_sd > 0`` normal
number t of each lane comes from the simulator-noise Philox stream (K1),
in the kernel on the card and by the plain twin on the CPU; only the plain
version also takes the noise as a given ``(B, n_obs)`` tensor (the parity
tests feed it JAX's numbers, ``observed_ode_family`` numpy's).

The segmented family (``ode_family(segments=...)``, ``pyabc_tpu/models/
model_selection.py:83-138``) is ``ode_family_segments``: K19's range entry
(``(carry, theta, seg_from, seg_to)`` -> the statistics of those
segments) over ``OdeFamilySegSpec``s, one per model, each lane stepping
its own model's descriptor (``m``); the step (``csrc/ode_family.cuh``) is
the one K18 runs a segment at a time. It observes at the ``n_obs`` times
after t = 0, ``n_substeps`` RK4 steps of ``dt = (t1 / n_obs) /
n_substeps`` each (rounded once to float32 from double, as JAX does), the
rates padded to 2 (m0 integrates with b = 0), and observation j of
segment s takes normal number ``s * obs_per_seg + j`` of the lane's
simulator-noise stream (JAX folds that index into the carried key).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..models.ode import rk4_at_times
from . import _build
from .base import Kernel
from .philox import PhiloxStream, normals
from .tau_leap import MAX_MODELS, ODE_FAMILY, SegModelC, segments_plain

#: the family's models, in model-index order
MODEL_NAMES = ("decay", "decay_production", "logistic")


def family_rhs(k: int, a: torch.Tensor, c: torch.Tensor):
    """Model k's right-hand side with the JAX package's operation order
    (``c`` is b for model 1 and k for model 2; model 0 ignores it)."""
    if k == 0:
        return lambda y: -a * y
    if k == 1:
        return lambda y: -a * y + c
    return lambda y: a * y * (1.0 - y / c)


def ode_family_simulate_plain(theta: torch.Tensor, m: torch.Tensor, *,
                              n_obs: int, n_substeps: int, dt: float,
                              y0: float = 2.0, noise_sd: float = 0.0,
                              stream: PhiloxStream | None = None,
                              noise: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch version: every model on every lane, each lane's own
    model's trajectory kept -> ``(B, n_obs)``."""
    B = theta.shape[0]
    a = theta[:, 0]
    c = theta[:, 1] if theta.shape[1] > 1 else torch.zeros_like(a)
    y_init = torch.full((1, B), float(y0), dtype=torch.float32,
                        device=theta.device)
    out = torch.zeros(B, n_obs, dtype=torch.float32, device=theta.device)
    for k in range(len(MODEL_NAMES)):
        ck = torch.zeros_like(c) if k == 0 else c
        traj = rk4_at_times(family_rhs(k, a, ck), y_init, n_obs, n_substeps,
                            dt)[:, 0, :].T
        out = torch.where((m == k)[:, None], traj, out)
    if noise_sd > 0:
        if noise is None:
            lanes = torch.arange(B, dtype=torch.int64, device=theta.device)
            noise = normals(stream, lanes, 0, n_obs)
        out = out + noise_sd * noise
    return out.contiguous()


class OdeFamilySimulate(Kernel):
    name = "ode_family_simulate"
    source = "pyabc_tpu_torch/csrc/ode_family_rk4.cu"
    replaces = "pyabc_tpu/models/model_selection.py:53"

    def __call__(self, theta: torch.Tensor, m: torch.Tensor, *, n_obs: int,
                 n_substeps: int, dt: float, y0: float = 2.0,
                 noise_sd: float = 0.0, stream: PhiloxStream | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        kw = dict(n_obs=n_obs, n_substeps=n_substeps, dt=dt, y0=y0,
                  noise_sd=noise_sd, stream=stream, noise=noise)
        extra = [t for t in (noise, stream and stream.counters)
                 if t is not None]
        if self.on_cpu(theta, m, *extra):
            return ode_family_simulate_plain(theta, m, **kw)
        if noise is not None:
            raise ValueError(f"{self.name}: the kernel draws its noise on "
                             f"the stream; a given noise tensor is for the "
                             f"plain version")
        if noise_sd > 0 and stream is None:
            raise ValueError(f"{self.name}: noise_sd > 0 needs a stream")
        B, stride = theta.shape
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(m, "m", torch.int32, (B,))
        key, gen, tag, max_rounds, ctr = (0, 0), 0, 0, 1, None
        if stream is not None:
            self.expect(stream.counters, "counters", torch.int32,
                        (stream.counters.shape[0],))
            key, gen, tag = stream.key, stream.generation, stream.tag
            max_rounds, ctr = stream.max_rounds, stream.counters.data_ptr()
        out = torch.empty(B, n_obs, dtype=torch.float32, device=theta.device)
        err = _build.library().pyabc_ode_family_simulate(
            theta.data_ptr(), m.data_ptr(), B, stride, n_obs, n_substeps,
            float(dt), float(y0), float(noise_sd), *key, gen, tag,
            max_rounds, ctr, out.data_ptr(), _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.launches += 1
        return out


ode_family_simulate = OdeFamilySimulate()


# ------------------------------------------------------ the segmented family
@dataclass(frozen=True)
class OdeFamilySegSpec:
    """One model of the segmented family: what K18 and the range kernel
    need to step it on the card and what its plain step needs."""

    variant: int
    n_obs: int = 12
    t1: float = 8.0
    n_substeps: int = 6
    n_seg: int = 4
    noise_sd: float = 0.3
    y0: float = 2.0

    kind = ODE_FAMILY

    @property
    def dt(self) -> float:
        return (self.t1 / self.n_obs) / self.n_substeps

    @property
    def obs_per_seg(self) -> int:
        return self.n_obs // self.n_seg

    @property
    def seg_size(self) -> int:
        return self.obs_per_seg

    def lane_params(self, theta: torch.Tensor) -> torch.Tensor:
        """The rates ``(B, 2)``: (a, 0) for the decay model, (a, b or k)
        for the others."""
        a = theta[:, 0]
        b = (torch.zeros_like(a) if self.variant == 0 else theta[:, 1])
        return torch.stack([a, b], dim=1)

    def initial_state(self, B: int, device) -> torch.Tensor:
        return torch.full((B, 1), float(self.y0), dtype=torch.float32,
                          device=device)

    def rhs(self, y, a, b):
        """dy with the JAX package's float32 order (a tensor divides by a
        tensor, one rounding, as the kernel's)."""
        if self.variant == 0:
            return -a * y
        if self.variant == 1:
            return -a * y + b
        return (a * y) * (1.0 - y / b)

    def rk4(self, y, a, b):
        dt, h2, h6 = self.dt, 0.5 * self.dt, self.dt / 6.0
        k1 = self.rhs(y, a, b)
        k2 = self.rhs(y + h2 * k1, a, b)
        k3 = self.rhs(y + h2 * k2, a, b)
        k4 = self.rhs(y + dt * k3, a, b)
        return y + h6 * (((k1 + 2.0 * k2) + 2.0 * k3) + k4)

    def step(self, y, params, seg: int, stream: PhiloxStream,
             lanes: torch.Tensor):
        """One segment of every lane -> (state ``(B, 1)``, ``(B,
        obs_per_seg)``)."""
        a, b = params[:, 0], params[:, 1]
        yy = y[:, 0]
        out = []
        for _j in range(self.obs_per_seg):
            for _q in range(self.n_substeps):
                yy = self.rk4(yy, a, b)
            out.append(yy)
        vals = torch.stack(out, dim=1)
        if self.noise_sd > 0:
            lo = seg * self.obs_per_seg
            z = normals(stream, lanes, 0, lo + self.obs_per_seg)[:, lo:]
            vals = vals + self.noise_sd * z
        return yy[:, None], vals

    def c_model(self) -> SegModelC:
        return SegModelC(
            kind=ODE_FAMILY, midpoint=0, n_seg=self.n_seg,
            seg_size=self.seg_size, leaps_per_seg=0, save_every=1,
            obs_per_seg=self.obs_per_seg, n_sub=self.n_substeps,
            variant=self.variant, x0_0=self.y0, dt=self.dt,
            h2=0.5 * self.dt, h6=self.dt / 6.0, noise_sd=self.noise_sd)


def _specs(spec) -> list:
    return list(spec) if isinstance(spec, (list, tuple)) else [spec]


def ode_family_segments_plain(spec, theta: torch.Tensor,
                              stream: PhiloxStream, *, m=None, **kw):
    """Plain PyTorch version: every model on every lane, each lane's own
    model's values and final state kept -> (out, final state)."""
    out = state = None
    for k, sp in enumerate(_specs(spec)):
        o, st = segments_plain(sp, theta, stream, **kw)
        if out is None:
            out, state = o, st
        else:
            sel = (m == k)[:, None]
            out, state = torch.where(sel, o, out), torch.where(sel, st,
                                                               state)
    return out, state


class OdeFamilySegments(Kernel):
    """The range entry of the segmented family (K19's form, with the
    lanes' models)."""

    name = "ode_family_segments"
    source = "pyabc_tpu_torch/csrc/ode_family_rk4.cu"
    replaces = "pyabc_tpu/models/model_selection.py:83"

    def __call__(self, spec, theta: torch.Tensor, stream: PhiloxStream, *,
                 m: torch.Tensor | None = None,
                 state: torch.Tensor | None = None, seg_from: int = 0,
                 seg_to: int | None = None,
                 colmap: torch.Tensor | None = None,
                 width: int | None = None, return_state: bool = False):
        """``spec`` is one model's ``OdeFamilySegSpec`` (every lane that
        model) or the family's K specs with the lanes' models ``m``."""
        specs = _specs(spec)
        seg_to = specs[0].n_seg if seg_to is None else seg_to
        kw = dict(state=state, seg_from=seg_from, seg_to=seg_to,
                  colmap=colmap, width=width)
        opt = [t for t in (state, colmap, m) if t is not None]
        if self.on_cpu(theta, stream.counters, *opt):
            return ode_family_segments_plain(spec, theta, stream, m=m, **kw)
        if len(specs) > 1 and m is None:
            raise ValueError(f"{self.name}: several models need m")
        if len(specs) > MAX_MODELS:
            raise ValueError(f"{self.name}: at most {MAX_MODELS} models")
        B, stride = theta.shape
        dev = theta.device
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        if m is not None:
            self.expect(m, "m", torch.int32, (B,))
        seg_size = specs[0].seg_size
        if colmap is None:
            colmap = torch.arange((seg_to - seg_from) * seg_size,
                                  dtype=torch.int32, device=dev).reshape(
                seg_to - seg_from, seg_size)
        self.expect(colmap, "colmap", torch.int32,
                    (seg_to - seg_from, seg_size))
        width = colmap.numel() if width is None else int(width)
        if state is not None:
            self.expect(state, "state", torch.float32, (B, 1))
        out = torch.empty(B, width, dtype=torch.float32, device=dev)
        y_out = (torch.empty(B, 1, dtype=torch.float32, device=dev)
                 if return_state else None)
        models = (SegModelC * MAX_MODELS)(*[s.c_model() for s in specs])
        err = _build.library().pyabc_ode_family_segments(
            ctypes.addressof(models), len(specs), self.ptr(m),
            theta.data_ptr(), B, stride, self.ptr(state), self.ptr(y_out),
            seg_from, seg_to, colmap.data_ptr(), width, out.data_ptr(),
            *stream.key, stream.generation, stream.tag, stream.max_rounds,
            stream.counters.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out, y_out


ode_family_segments = OdeFamilySegments()
