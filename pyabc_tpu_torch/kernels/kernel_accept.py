"""K21a: noise-model log-density, stochastic accept test and importance
log-weight of one round (the stochastic twin of K5).

Counterpart of ``pyabc_tpu/distance/kernel.py::IndependentNormalKernel.
device_fn`` + ``acceptor/acceptor.py::StochasticAcceptor.device_fn`` + the
log-weight sums of ``inference/util.py::_lane_prior`` /
``_lane_transition``; the CUDA kernel is ``csrc/kernel_accept.cu``. Each
lane's uniform is word 0 of block 0 of the accept stream (``philox.ACCEPT``,
K1), in the kernel on the card and by the plain twin on the CPU. The
temperature and the pdf norm are device scalars.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel
from .philox import PhiloxStream, uniforms

_LOG_2PI = math.log(2.0 * math.pi)


def normal_logdensity_rows(ss: torch.Tensor, x0: torch.Tensor,
                           var: torch.Tensor) -> torch.Tensor:
    """``IndependentNormalKernel.device_fn`` of every row: -0.5 sum((log 2
    pi + log var) + diff^2 / var)."""
    diff = ss - x0
    return -0.5 * ((_LOG_2PI + torch.log(var)) + diff * diff / var).sum(-1)


def accept_uniforms(stream: PhiloxStream, B: int) -> torch.Tensor:
    """The ``(B,)`` uniforms the kernel draws on ``stream``."""
    lanes = torch.arange(B, dtype=torch.int64, device=stream.counters.device)
    return uniforms(stream, lanes, 0, 0)


def kernel_accept_plain(ss, x0, var, temp, pdf_norm, valid, *,
                        stream: PhiloxStream, lin: bool, apply_iw: bool,
                        logpri=None, logq=None):
    """Plain PyTorch version -> (kernel value v, accept, log_weight)."""
    v = normal_logdensity_rows(ss, x0, var)
    logv = torch.log(v.clamp_min(1e-30)) if lin else v
    log_ratio = (logv - pdf_norm) / temp
    u = accept_uniforms(stream, ss.shape[0])
    accept = valid & (torch.log(u) < log_ratio)
    log_acc_w = torch.where((log_ratio > 0) & apply_iw, log_ratio,
                            torch.zeros_like(log_ratio))
    lw = log_acc_w if logpri is None else (logpri + log_acc_w) - logq
    lw = torch.where(valid, lw, torch.full_like(lw, -math.inf))
    return v, accept, lw


class KernelAccept(Kernel):
    name = "kernel_accept"
    source = "pyabc_tpu_torch/csrc/kernel_accept.cu"
    replaces = "pyabc_tpu/acceptor/acceptor.py:306"

    def __call__(self, ss, x0, var, temp, pdf_norm, valid, *,
                 stream: PhiloxStream, lin: bool, apply_iw: bool,
                 logpri=None, logq=None):
        kw = dict(stream=stream, lin=lin, apply_iw=apply_iw, logpri=logpri,
                  logq=logq)
        opt = [t for t in (logpri, logq) if t is not None]
        if self.on_cpu(ss, x0, var, temp, pdf_norm, valid, stream.counters,
                       *opt):
            return kernel_accept_plain(ss, x0, var, temp, pdf_norm, valid,
                                       **kw)
        if (logpri is None) != (logq is None):
            raise ValueError(f"{self.name}: logpri and logq go together")
        B, S = ss.shape
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        self.expect(var, "var", f32, (S,))
        self.expect(temp, "temp", f32, ())
        self.expect(pdf_norm, "pdf_norm", f32, ())
        self.expect(valid, "valid", torch.bool, (B,))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        if logpri is not None:
            self.expect(logpri, "logpri", f32, (B,))
            self.expect(logq, "logq", f32, (B,))
        dev = ss.device
        v = torch.empty(B, dtype=f32, device=dev)
        accept = torch.empty(B, dtype=torch.bool, device=dev)
        lw = torch.empty(B, dtype=f32, device=dev)
        err = _build.library().pyabc_kernel_accept(
            ss.data_ptr(), B, S, x0.data_ptr(), var.data_ptr(),
            valid.data_ptr(), temp.data_ptr(), pdf_norm.data_ptr(),
            int(bool(lin)), int(bool(apply_iw)), self.ptr(logpri),
            self.ptr(logq), *stream.key, stream.generation, stream.tag,
            stream.max_rounds, stream.counters.data_ptr(), v.data_ptr(),
            accept.data_ptr(), lw.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return v, accept, lw


kernel_accept = KernelAccept()
