"""K20: the SIR RK4 simulator of one proposal round.

Counterpart of ``pyabc_tpu/models/ode.py::rk4_at_times`` with
``models/sir.py::_sir_rhs`` vmapped over a round (``make_sir_model``); the
CUDA kernel is ``csrc/sir_rk4.cu``. The output is the infected compartment
at the ``n_obs`` observation times, ``(B, n_obs)``. With ``noise_sd > 0``
normal number i of each lane comes from the simulator-noise Philox stream
(K1), in the kernel on the card and by the plain twin on the CPU, at the
lane's global number (the stream's ``lane0`` plus its index); the
deterministic model of BASELINE config 4 (``noise_sd = 0``) draws nothing.
"""
from __future__ import annotations

import torch

from ..models.ode import rk4_at_times
from . import _build
from .base import LaneKernel
from .philox import PhiloxStream, lanes, normals


def sir_rhs(s, i, r, beta, gamma, n_pop: float):
    """Batched ``_sir_rhs`` with the JAX package's operation order."""
    inf = beta * s * i / n_pop
    rec = gamma * i
    return -inf, inf - rec, rec


def sir_simulate_plain(theta: torch.Tensor, *, n_obs: int, n_substeps: int,
                       dt: float, n_pop: float, noise_sd: float = 0.0,
                       stream: PhiloxStream | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``(B, >= 2)`` theta -> ``(B, n_obs)``."""
    beta, gamma = theta[:, 0], theta[:, 1]

    def rhs(y):
        return torch.stack(sir_rhs(y[0], y[1], y[2], beta, gamma, n_pop))

    B = theta.shape[0]
    y0 = torch.tensor([n_pop - 1.0, 1.0, 0.0], dtype=torch.float32,
                      device=theta.device)[:, None].expand(3, B)
    infected = rk4_at_times(rhs, y0, n_obs, n_substeps, dt)[:, 1, :].T
    if noise_sd > 0:
        infected = infected + noise_sd * normals(stream, lanes(stream, B), 0,
                                                 n_obs)
    return infected.contiguous()


class SirSimulate(LaneKernel):
    name = "sir_simulate"
    source = "pyabc_tpu_torch/csrc/sir_rk4.cu"
    replaces = "pyabc_tpu/models/sir.py:30"

    def __call__(self, theta: torch.Tensor, *, n_obs: int, n_substeps: int,
                 dt: float, n_pop: float, noise_sd: float = 0.0,
                 stream: PhiloxStream | None = None) -> torch.Tensor:
        if noise_sd > 0 and stream is None:
            raise ValueError(f"{self.name}: noise_sd > 0 needs a stream")
        extra = [stream.counters] if stream is not None else []
        kw = dict(n_obs=n_obs, n_substeps=n_substeps, dt=dt, n_pop=n_pop,
                  noise_sd=noise_sd, stream=stream)
        if self.on_cpu(theta, *extra):
            return sir_simulate_plain(theta, **kw)
        B, stride = theta.shape
        if stride < 2:
            raise ValueError(f"{self.name}: theta needs 2 columns")
        self.expect(theta, "theta", torch.float32, (B, stride))
        key, gen, tag, max_rounds, lane0, ctr = (0, 0), 0, 0, 1, 0, None
        if stream is not None:
            self.expect(stream.counters, "counters", torch.int32,
                        (stream.counters.shape[0],))
            key, gen, tag = stream.key, stream.generation, stream.tag
            max_rounds, lane0 = stream.max_rounds, int(stream.lane0)
            ctr = stream.counters.data_ptr()
        out = torch.empty(B, n_obs, dtype=torch.float32, device=theta.device)
        err = _build.library().pyabc_sir_simulate(
            theta.data_ptr(), B, stride, n_obs, n_substeps, float(dt),
            float(n_pop), float(noise_sd), *key, gen, tag, max_rounds, lane0,
            ctr, out.data_ptr(), _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.count_launch(stream)
        return out


sir_simulate = SirSimulate()
