"""K3: log-density of proposals under the MVN mixture transition.

Counterpart of ``pyabc_tpu/transition/multivariatenormal.py::device_logpdf``
vmapped over a round. ``params`` is the fitted transition dict
(``prec``, ``center``, ``thetas_c``, ``quad``, ``weights``, ``logdet``,
``dim``); the CUDA kernel is ``csrc/mvn_logpdf.cu``.

K > 1 mode (``mvn_mixture_logpdf.models``): each lane is scored under the
mixture of its own model, from stacked params (every tensor with a leading
model axis, ``dims (K,)`` float32 the models' true dims; ``model_params``
takes one model's slice).
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


def model_params(params: dict, k: int) -> dict:
    """Model ``k``'s params out of stacked (K > 1) params: each tensor's
    slice ``[k]`` and ``dim`` a Python float (a host read of ``dims``, for
    the CPU and the tests)."""
    out = {key: v[k] for key, v in params.items()
           if isinstance(v, torch.Tensor) and key != "dims"}
    out["dim"] = float(params["dims"][k])
    return out


def mvn_mixture_logpdf_models_plain(q: torch.Tensor, m: torch.Tensor,
                                    params: dict) -> torch.Tensor:
    """Plain PyTorch version of the K > 1 mode: every model's mixture on
    every lane, each lane's own model's kept."""
    out = torch.zeros(q.shape[0], dtype=q.dtype, device=q.device)
    for k in range(params["dims"].shape[0]):
        lq = mvn_mixture_logpdf_plain(q, model_params(params, k))
        out = torch.where(m == k, lq, out)
    return out


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

    def models(self, q: torch.Tensor, m: torch.Tensor,
               params: dict) -> torch.Tensor:
        """The K > 1 mode: ``(B, d_max)`` queries, their models ``m (B,)``
        int32 and stacked params -> ``(B,)`` log-density."""
        keys = ("prec", "center", "thetas_c", "quad", "weights", "logdet",
                "dims")
        if self.on_cpu(q, m, *(params[k] for k in keys)):
            return mvn_mixture_logpdf_models_plain(q, m, params)
        B, d = q.shape
        K, n = params["weights"].shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32 = torch.float32
        self.expect(q, "q", f32, (B, d))
        self.expect(m, "m", torch.int32, (B,))
        self.expect(params["prec"], "prec", f32, (K, d, d))
        self.expect(params["center"], "center", f32, (K, d))
        self.expect(params["thetas_c"], "thetas_c", f32, (K, n, d))
        self.expect(params["quad"], "quad", f32, (K, n))
        self.expect(params["weights"], "weights", f32, (K, n))
        self.expect(params["logdet"], "logdet", f32, (K,))
        self.expect(params["dims"], "dims", f32, (K,))
        out = torch.empty(B, dtype=f32, device=q.device)
        err = _build.library().pyabc_mvn_mixture_logpdf_models(
            q.data_ptr(), m.data_ptr(), B, d,
            *(params[k].data_ptr() for k in keys[:5]), n,
            params["logdet"].data_ptr(), params["dims"].data_ptr(),
            out.data_ptr(), _build.stream_ptr(q.device))
        _build.check(err, self.name)
        self.launches += 1
        return out


mvn_mixture_logpdf = MvnMixtureLogpdf()
