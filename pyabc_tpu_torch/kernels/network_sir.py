"""K20b network: the ring-coupled metapopulation SIR of one proposal round,
over a range of segments.

Counterpart of ``pyabc_tpu/models/sir.py::make_network_sir_model``'s
segment step under ``vmap``; the CUDA kernel is ``csrc/network_sir_rk4.cu``
with the step in ``csrc/network_sir.cuh``, and K18 (``segment_round``)
runs the same step one segment at a time. The entry is K19's
(``tau_leap.RangeKernel``): ``(carry, theta, seg_from, seg_to)`` -> the
statistics of those segments; the carry is the state ``(B, 3, n_patches)``
(S, I, R of every patch).

Per observation ``n_substeps`` classic RK4 steps of ``dt = (t1 / n_obs) /
n_substeps``; the emitted block is the infected of every patch, time-major.
With ``noise_sd > 0`` statistic k of segment j gets ``noise_sd`` times
normal number ``j * seg_size + k`` of the lane on the simulator-noise
Philox stream (keyed by the slot and the segment; JAX splits the carried
key per segment).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .philox import PhiloxStream, normals
from .tau_leap import NETWORK_SIR, RangeKernel, SegModelC, segments_plain


@dataclass(frozen=True)
class NetworkSirSpec:
    n_patches: int = 8
    n_obs: int = 16
    t1: float = 60.0
    n_substeps: int = 4
    coupling: float = 0.08
    n_seg: int = 4
    noise_sd: float = 0.0
    n_pop: float = 1000.0
    seed_i: float = 5.0

    kind = NETWORK_SIR

    @property
    def dt(self) -> float:
        return (self.t1 / self.n_obs) / self.n_substeps

    @property
    def obs_per_seg(self) -> int:
        return self.n_obs // self.n_seg

    @property
    def seg_size(self) -> int:
        return self.obs_per_seg * self.n_patches

    def lane_params(self, theta: torch.Tensor) -> torch.Tensor:
        return theta[:, :2]

    def initial_state(self, B: int, device) -> torch.Tensor:
        y = torch.zeros(3, self.n_patches, dtype=torch.float32)
        y[0] = self.n_pop
        y[0, 0] = self.n_pop - self.seed_i
        y[1, 0] = self.seed_i
        return y.to(device).expand(B, 3, self.n_patches).clone()

    def rhs(self, s, i, beta, gamma):
        """dy with the JAX package's float32 order (sir.py:108-115)."""
        left = torch.roll(i, 1, dims=1)
        right = torch.roll(i, -1, dims=1)
        pressure = (1.0 - self.coupling) * i + (0.5 * self.coupling) * (
            left + right)
        # one rounded division, as the kernel's (a tensor divided by a
        # Python number is a product by its reciprocal on the card)
        inf = ((beta * s) * pressure) / torch.full_like(s, self.n_pop)
        rec = gamma * i
        return -inf, inf - rec, rec

    def rk4(self, y, beta, gamma):
        dt, h2, h6 = self.dt, 0.5 * self.dt, self.dt / 6.0
        s, i, r = y[:, 0], y[:, 1], y[:, 2]
        k1 = self.rhs(s, i, beta, gamma)
        k2 = self.rhs(s + h2 * k1[0], i + h2 * k1[1], beta, gamma)
        k3 = self.rhs(s + h2 * k2[0], i + h2 * k2[1], beta, gamma)
        k4 = self.rhs(s + dt * k3[0], i + dt * k3[1], beta, gamma)
        new = [y_c + h6 * (((a + 2.0 * b) + 2.0 * c) + d)
               for y_c, a, b, c, d in zip((s, i, r), k1, k2, k3, k4)]
        return torch.stack(new, dim=1)

    def step(self, y, params, seg: int, stream: PhiloxStream,
             lanes: torch.Tensor):
        """One segment of every lane -> (state, ``(B, seg_size)``)."""
        beta, gamma = params[:, 0:1], params[:, 1:2]
        out = []
        for _o in range(self.obs_per_seg):
            for _q in range(self.n_substeps):
                y = self.rk4(y, beta, gamma)
            out.append(y[:, 1])
        vals = torch.cat(out, dim=1)
        if self.noise_sd > 0:
            start = seg * self.seg_size
            z = normals(stream, lanes, start // 4,
                        start % 4 + self.seg_size)[:, start % 4:]
            vals = vals + self.noise_sd * z
        return y, vals

    def c_model(self) -> SegModelC:
        return SegModelC(
            kind=NETWORK_SIR, midpoint=0, n_seg=self.n_seg,
            seg_size=self.seg_size, leaps_per_seg=0, save_every=1,
            obs_per_seg=self.obs_per_seg, n_sub=self.n_substeps,
            dt=self.dt, h2=0.5 * self.dt, h6=self.dt / 6.0, n_pop=self.n_pop,
            c_self=1.0 - self.coupling, c_half=0.5 * self.coupling,
            seed_i=self.seed_i, noise_sd=self.noise_sd)


def network_sir_plain(spec: NetworkSirSpec, theta: torch.Tensor,
                      stream: PhiloxStream, **kw):
    """Plain PyTorch version of K20b network -> (out, final state)."""
    return segments_plain(spec, theta, stream, **kw)


class NetworkSir(RangeKernel):
    name = "network_sir"
    source = "pyabc_tpu_torch/csrc/network_sir_rk4.cu"
    replaces = "pyabc_tpu/models/sir.py:79"
    entry = "pyabc_network_sir"
    #: the patches the kernel keeps in registers
    KERNEL_PATCHES = 8

    @staticmethod
    def state_width(spec) -> int:
        return 3 * spec.n_patches

    def plain(self, spec, theta, stream, **kw):
        return network_sir_plain(spec, theta, stream, **kw)

    def __call__(self, spec, theta, stream, **kw):
        if theta.device.type == "cuda" and \
                spec.n_patches != self.KERNEL_PATCHES:
            raise ValueError(f"{self.name}: the kernel runs "
                             f"{self.KERNEL_PATCHES} patches, got "
                             f"{spec.n_patches}")
        return super().__call__(spec, theta, stream, **kw)


network_sir = NetworkSir()
