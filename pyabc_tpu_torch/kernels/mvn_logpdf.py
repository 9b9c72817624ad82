"""K3: log-density of proposals under the MVN mixture transition.

Counterpart of ``pyabc_tpu/transition/multivariatenormal.py::device_logpdf``
vmapped over a round. ``params`` is the fitted transition dict
(``prec``, ``center``, ``thetas_c``, ``quad``, ``weights``, ``logdet``,
``dim``); the CUDA kernel is ``csrc/mvn_logpdf.cu``.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel

_LOG_2PI = math.log(2.0 * math.pi)

#: register cap of the CUDA kernel's dim buckets
MAX_DIM = 32


def weighted_logsumexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.logsumexp(a, b=b, axis=-1)``: entries with
    b == 0 are masked out, an all-masked row gives -inf."""
    a = torch.where(b != 0, a, torch.full_like(a, -math.inf))
    amax = a.max(dim=-1, keepdim=True).values
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = (b * torch.exp(a - amax)).sum(dim=-1)
    return torch.log(s.abs()) + amax.squeeze(-1)


def mvn_mixture_logpdf_plain(q: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version: ``(B, d)`` queries -> ``(B,)`` log-density."""
    u = q - params["center"]
    pu = u @ params["prec"].T
    cross = pu @ params["thetas_c"].T
    maha = (u * pu).sum(dim=1, keepdim=True) - 2.0 * cross \
        + params["quad"][None, :]
    log_comp = -0.5 * (float(params["dim"]) * _LOG_2PI + params["logdet"]
                       + maha)
    return weighted_logsumexp(log_comp, params["weights"][None, :])


class MvnMixtureLogpdf(Kernel):
    name = "mvn_mixture_logpdf"
    source = "pyabc_tpu_torch/csrc/mvn_logpdf.cu"
    replaces = "pyabc_tpu/transition/multivariatenormal.py:196"

    def __call__(self, q: torch.Tensor, params: dict) -> torch.Tensor:
        keys = ("prec", "center", "thetas_c", "quad", "weights", "logdet")
        if self.on_cpu(q, *(params[k] for k in keys)):
            return mvn_mixture_logpdf_plain(q, params)
        B, d = q.shape
        n = params["thetas_c"].shape[0]
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32 = torch.float32
        self.expect(q, "q", f32, (B, d))
        self.expect(params["prec"], "prec", f32, (d, d))
        self.expect(params["center"], "center", f32, (d,))
        self.expect(params["thetas_c"], "thetas_c", f32, (n, d))
        self.expect(params["quad"], "quad", f32, (n,))
        self.expect(params["weights"], "weights", f32, (n,))
        self.expect(params["logdet"], "logdet", f32, ())
        out = torch.empty(B, dtype=f32, device=q.device)
        err = _build.library().pyabc_mvn_mixture_logpdf(
            q.data_ptr(), B, d, params["prec"].data_ptr(),
            params["center"].data_ptr(), params["thetas_c"].data_ptr(),
            params["quad"].data_ptr(), params["weights"].data_ptr(), n,
            params["logdet"].data_ptr(), float(params["dim"]),
            out.data_ptr(), _build.stream_ptr(q.device))
        _build.check(err, self.name)
        self.launches += 1
        return out


mvn_mixture_logpdf = MvnMixtureLogpdf()
