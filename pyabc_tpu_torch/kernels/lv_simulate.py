"""K4: the Lotka-Volterra RK4 simulator of one proposal round.

Counterpart of ``pyabc_tpu/models/ode.py::rk4_at_times`` with
``models/lotka_volterra.py::_lv_rhs`` vmapped over a round; the CUDA
kernel is ``csrc/lv_rk4.cu``. Output rows follow SumStatSpec's sorted
layout ``pred[0:n_obs] | prey[0:n_obs]``. The observation noise is drawn
from Philox (K1) on a ``PhiloxStream``: lane b's normal number s n_obs + i
for obs i of species s (0 prey, 1 pred), in the kernel on the card and by
the plain twin on the CPU, so both consume the same stream. Only the plain
version also takes the noise as a given ``(B, 2, n_obs)`` tensor (the
parity tests feed it numpy's numbers, and ``observed_data`` draws it so).
"""
from __future__ import annotations

import torch

from ..models.ode import rk4_at_times
from . import _build
from .base import LaneKernel
from .philox import PhiloxStream, lanes, normals


def lv_rhs(prey, pred, alpha, beta, gamma, delta):
    """Batched ``_lv_rhs`` with the JAX package's operation order."""
    dprey = alpha * prey - beta * prey * pred
    dpred = delta * prey * pred - gamma * pred
    return dprey, dpred


def lv_noise_plain(stream: PhiloxStream, B: int, n_obs: int) -> torch.Tensor:
    """The ``(B, 2, n_obs)`` noise the kernel draws on ``stream``."""
    return normals(stream, lanes(stream, B), 0, 2 * n_obs).reshape(
        B, 2, n_obs)


def lv_simulate_plain(theta: torch.Tensor, noise: torch.Tensor | None, *,
                      n_obs: int, n_substeps: int, dt: float,
                      y0: tuple[float, float], noise_sd: float,
                      log_parameters: bool,
                      stream: PhiloxStream | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``(B, >=4)`` theta, ``(B, 2, n_obs)`` noise
    ([:, 0] prey, [:, 1] pred) or None to draw it on ``stream`` ->
    ``(B, 2 * n_obs)``."""
    if noise is None:
        noise = lv_noise_plain(stream, theta.shape[0], n_obs)
    th = theta[:, :4]
    if log_parameters:
        th = torch.pow(torch.tensor(10.0, dtype=th.dtype, device=th.device),
                       th)
    alpha, beta, gamma, delta = th.unbind(dim=1)

    def rhs(y):
        dprey, dpred = lv_rhs(y[0], y[1], alpha, beta, gamma, delta)
        return torch.stack([dprey, dpred])

    B = theta.shape[0]
    y_init = torch.tensor(y0, dtype=torch.float32, device=theta.device)
    y_init = y_init[:, None].expand(2, B)
    traj = rk4_at_times(rhs, y_init, n_obs, n_substeps, dt)  # (n_obs, 2, B)
    traj = clip_keep_nan(traj, 0.0, 1e6)
    prey = traj[:, 0, :].T + noise_sd * noise[:, 0, :]
    pred = traj[:, 1, :].T + noise_sd * noise[:, 1, :]
    return torch.cat([pred, prey], dim=1)


def clip_keep_nan(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: NaN stays NaN."""
    return torch.where(torch.isnan(x), x, x.clamp(lo, hi))


class LvSimulate(LaneKernel):
    name = "lv_simulate"
    source = "pyabc_tpu_torch/csrc/lv_rk4.cu"
    replaces = "pyabc_tpu/models/ode.py:104"

    def __call__(self, theta: torch.Tensor, noise: torch.Tensor | None, *,
                 n_obs: int, n_substeps: int, dt: float,
                 y0: tuple[float, float], noise_sd: float,
                 log_parameters: bool,
                 stream: PhiloxStream | None = None) -> torch.Tensor:
        if (noise is None) == (stream is None):
            raise ValueError(f"{self.name}: give the noise or a stream")
        src = noise if noise is not None else stream.counters
        if self.on_cpu(theta, src):
            return lv_simulate_plain(
                theta, noise, n_obs=n_obs, n_substeps=n_substeps, dt=dt,
                y0=y0, noise_sd=noise_sd, log_parameters=log_parameters,
                stream=stream)
        B, stride = theta.shape
        if stride < 4:
            raise ValueError(f"{self.name}: theta needs 4 columns")
        if noise is not None:
            raise ValueError(f"{self.name}: on the card the noise is drawn "
                             f"in the kernel; give a PhiloxStream")
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        out = torch.empty(B, 2 * n_obs, dtype=torch.float32,
                          device=theta.device)
        err = _build.library().pyabc_lv_simulate(
            theta.data_ptr(), B, stride, n_obs, n_substeps, float(dt),
            float(y0[0]), float(y0[1]), float(noise_sd),
            int(bool(log_parameters)), *stream.key, stream.generation,
            stream.tag, stream.max_rounds, int(stream.lane0),
            stream.counters.data_ptr(), out.data_ptr(),
            _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.count_launch(stream)
        return out


lv_simulate = LvSimulate()
