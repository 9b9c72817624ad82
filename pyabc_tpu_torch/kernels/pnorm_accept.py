"""K5: p-norm distance, uniform accept test and importance log-weight.

Counterpart of ``pyabc_tpu/distance/pnorm.py::PNormDistance.device_fn`` +
``acceptor/acceptor.py::UniformAcceptor.device_fn`` + the log-weight sum of
``inference/util.py::_lane_transition``; the CUDA kernel is
``csrc/pnorm_accept.cu``.

K > 1 (``m``, ``model_logits`` and ``log_model_factor`` given, a
transition round of a run over several models): the log weight is
``model_logits[m] + logpri - log_model_factor[m] - logq``
(``util.py:399-406``), both K-vectors read on the device by the lane's
model.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .base import Kernel


def pnorm_rows(ss: torch.Tensor, x0: torch.Tensor, w: torch.Tensor,
               p: float) -> torch.Tensor:
    """Weighted p-norm of every row of ``ss`` against ``x0``."""
    diff = w * (ss - x0).abs()
    if math.isinf(p):
        return diff.max(dim=-1).values
    return (diff ** p).sum(dim=-1) ** (1.0 / p)


def pnorm_accept_weight_plain(ss, x0, w, eps, valid, *, p: float,
                              hist_min=None, logpri=None, logq=None,
                              log_offset: float = 0.0, m=None,
                              model_logits=None, log_model_factor=None):
    """Plain PyTorch version -> (distance, accept, log_weight)."""
    return accept_epilogue_plain(
        pnorm_rows(ss, x0, w, p), eps, valid, hist_min=hist_min,
        logpri=logpri, logq=logq, log_offset=log_offset, m=m,
        model_logits=model_logits, log_model_factor=log_model_factor)


def accept_epilogue_plain(d, eps, valid, *, hist_min=None, logpri=None,
                          logq=None, log_offset: float = 0.0, m=None,
                          model_logits=None, log_model_factor=None):
    """The accept test and log weight of distances ``d`` (the epilogue K5
    shares with K25, ``csrc/accept_epilogue.cuh``) -> (d, accept,
    log_weight)."""
    accept = valid & (d <= eps)
    if hist_min is not None:
        accept = accept & (d <= hist_min)
    if logpri is None:
        lw = torch.zeros_like(d)
    elif m is not None:
        mi = m.long()
        lw = (model_logits[mi] + logpri - log_model_factor[mi]) - logq
    else:
        lw = log_offset + logpri - logq
    lw = torch.where(valid, lw, torch.full_like(lw, -math.inf))
    return d, accept, lw


def expect_terms(kernel: Kernel, B: int, eps, valid, hist_min, logpri, logq,
                 m, model_logits, log_model_factor) -> None:
    """Check the epilogue's inputs of a launch over B rows (K5, K25)."""
    if (logpri is None) != (logq is None):
        raise ValueError(f"{kernel.name}: logpri and logq go together")
    models = (m, model_logits, log_model_factor)
    if any(t is None for t in models) != all(t is None for t in models) \
            or (m is not None and logpri is None):
        raise ValueError(f"{kernel.name}: m, model_logits and "
                         f"log_model_factor go together, with logpri")
    f32 = torch.float32
    kernel.expect(eps, "eps", f32, ())
    kernel.expect(valid, "valid", torch.bool, (B,))
    if hist_min is not None:
        kernel.expect(hist_min, "hist_min", f32, ())
    if logpri is not None:
        kernel.expect(logpri, "logpri", f32, (B,))
        kernel.expect(logq, "logq", f32, (B,))
    if m is not None:
        K = model_logits.shape[0]
        kernel.expect(m, "m", torch.int32, (B,))
        kernel.expect(model_logits, "model_logits", f32, (K,))
        kernel.expect(log_model_factor, "log_model_factor", f32, (K,))


class PnormAcceptWeight(Kernel):
    name = "pnorm_accept_weight"
    source = "pyabc_tpu_torch/csrc/pnorm_accept.cu"
    replaces = "pyabc_tpu/distance/pnorm.py:204"

    def __call__(self, ss, x0, w, eps, valid, *, p: float, hist_min=None,
                 logpri=None, logq=None, log_offset: float = 0.0, m=None,
                 model_logits=None, log_model_factor=None):
        models = (m, model_logits, log_model_factor)
        opt = [t for t in (hist_min, logpri, logq, *models)
               if t is not None]
        if self.on_cpu(ss, x0, w, eps, valid, *opt):
            return pnorm_accept_weight_plain(
                ss, x0, w, eps, valid, p=p, hist_min=hist_min,
                logpri=logpri, logq=logq, log_offset=log_offset, m=m,
                model_logits=model_logits,
                log_model_factor=log_model_factor)
        B, S = ss.shape
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        self.expect(w, "w", f32, (S,))
        expect_terms(self, B, eps, valid, hist_min, logpri, logq, *models)
        dev = ss.device
        d = torch.empty(B, dtype=f32, device=dev)
        accept = torch.empty(B, dtype=torch.bool, device=dev)
        lw = torch.empty(B, dtype=f32, device=dev)
        err = _build.library().pyabc_pnorm_accept_weight(
            ss.data_ptr(), B, S, x0.data_ptr(), w.data_ptr(), float(p),
            valid.data_ptr(), eps.data_ptr(), self.ptr(hist_min),
            self.ptr(logpri), self.ptr(logq), float(log_offset),
            *(self.ptr(t) for t in models), d.data_ptr(),
            accept.data_ptr(), lw.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return d, accept, lw


pnorm_accept_weight = PnormAcceptWeight()
