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
"""
from __future__ import annotations

import torch

from ..models.ode import rk4_at_times
from . import _build
from .base import Kernel
from .philox import PhiloxStream, normals

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
