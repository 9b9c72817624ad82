"""K4: the Lotka-Volterra RK4 simulator of one proposal round.

Counterpart of ``pyabc_tpu/models/ode.py::rk4_at_times`` with
``models/lotka_volterra.py::_lv_rhs`` vmapped over a round; the CUDA
kernel is ``csrc/lv_rk4.cu``. Output rows follow SumStatSpec's sorted
layout ``pred[0:n_obs] | prey[0:n_obs]``.
"""
from __future__ import annotations

import torch

from ..models.ode import rk4_at_times
from . import _build
from .base import Kernel


def lv_rhs(prey, pred, alpha, beta, gamma, delta):
    """Batched ``_lv_rhs`` with the JAX package's operation order."""
    dprey = alpha * prey - beta * prey * pred
    dpred = delta * prey * pred - gamma * pred
    return dprey, dpred


def lv_simulate_plain(theta: torch.Tensor, noise: torch.Tensor, *,
                      n_obs: int, n_substeps: int, dt: float,
                      y0: tuple[float, float], noise_sd: float,
                      log_parameters: bool) -> torch.Tensor:
    """Plain PyTorch version: ``(B, >=4)`` theta, ``(B, 2, n_obs)`` noise
    ([:, 0] prey, [:, 1] pred) -> ``(B, 2 * n_obs)``."""
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


class LvSimulate(Kernel):
    name = "lv_simulate"
    source = "pyabc_tpu_torch/csrc/lv_rk4.cu"
    replaces = "pyabc_tpu/models/ode.py:104"

    def __call__(self, theta: torch.Tensor, noise: torch.Tensor, *,
                 n_obs: int, n_substeps: int, dt: float,
                 y0: tuple[float, float], noise_sd: float,
                 log_parameters: bool) -> torch.Tensor:
        if self.on_cpu(theta, noise):
            return lv_simulate_plain(
                theta, noise, n_obs=n_obs, n_substeps=n_substeps, dt=dt,
                y0=y0, noise_sd=noise_sd, log_parameters=log_parameters)
        B, stride = theta.shape
        if stride < 4:
            raise ValueError(f"{self.name}: theta needs 4 columns")
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(noise, "noise", torch.float32, (B, 2, n_obs))
        out = torch.empty(B, 2 * n_obs, dtype=torch.float32,
                          device=theta.device)
        err = _build.library().pyabc_lv_simulate(
            theta.data_ptr(), B, stride, noise.data_ptr(), n_obs,
            n_substeps, float(dt), float(y0[0]), float(y0[1]),
            float(noise_sd), int(bool(log_parameters)), out.data_ptr(),
            _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.launches += 1
        return out


lv_simulate = LvSimulate()
