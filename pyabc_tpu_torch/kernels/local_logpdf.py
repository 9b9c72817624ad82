"""K14 (density): log-density of proposals under LocalTransition's mixture.

Counterpart of ``pyabc_tpu/transition/local_transition.py::device_logpdf``
vmapped over a round; the CUDA kernel is ``csrc/local_logpdf.cu``. The
mixture has one Gaussian per component j with its own precision
``precs[j]``, scored in the DIFF form (``maha_j = (q - theta_j)' P_j (q -
theta_j)``): the centred expansion K3 uses cancels catastrophically with
local precisions. ``lconst[j] = log w_j - 0.5 (dim log 2 pi + logdet_j)``
comes from K13; components with w_j = 0 contribute nothing.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel

MAX_DIM = 16
#: query-component pairs a chunk of the plain version holds
PLAIN_PAIRS = 1 << 22


def local_logpdf_plain(q: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version: ``(B, d)`` queries -> ``(B,)``, in chunks of
    queries."""
    th, P = params["thetas"], params["precs"]
    live = params["weights"] > 0
    lconst = torch.where(live, params["lconst"],
                         torch.full_like(params["lconst"], -math.inf))
    B, n = q.shape[0], th.shape[0]
    step = max(1, PLAIN_PAIRS // max(n, 1))
    out = torch.empty(B, dtype=q.dtype, device=q.device)
    for b0 in range(0, B, step):
        diff = q[b0:b0 + step, None, :] - th[None, :, :]
        maha = torch.einsum("bnd,nde,bne->bn", diff, P, diff)
        out[b0:b0 + step] = torch.logsumexp(lconst[None, :] - 0.5 * maha,
                                            dim=1)
    return out


class LocalLogpdf(Kernel):
    name = "local_logpdf"
    source = "pyabc_tpu_torch/csrc/local_logpdf.cu"
    replaces = "pyabc_tpu/transition/local_transition.py:442"

    def __call__(self, q: torch.Tensor, params: dict) -> torch.Tensor:
        keys = ("thetas", "precs", "lconst", "weights")
        if self.on_cpu(q, *(params[k] for k in keys)):
            return local_logpdf_plain(q, params)
        B, d = q.shape
        n = params["thetas"].shape[0]
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"register cap {MAX_DIM}")
        f32 = torch.float32
        self.expect(q, "q", f32, (B, d))
        self.expect(params["thetas"], "thetas", f32, (n, d))
        self.expect(params["precs"], "precs", f32, (n, d, d))
        self.expect(params["lconst"], "lconst", f32, (n,))
        self.expect(params["weights"], "weights", f32, (n,))
        out = torch.empty(B, dtype=f32, device=q.device)
        err = _build.library().pyabc_local_logpdf(
            q.data_ptr(), B, d, *(params[k].data_ptr() for k in keys), n,
            out.data_ptr(), _build.stream_ptr(q.device))
        _build.check(err, self.name)
        self.launches += 1
        return out


local_logpdf = LocalLogpdf()
