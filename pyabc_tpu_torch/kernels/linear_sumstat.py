"""K23 transform (the linear plan): learned summary statistics and the
accept test through them.

Counterpart of ``pyabc_tpu/predictor/predictor.py::LinearPredictor.
device_predict`` inside ``distance/pnorm.py::PNormDistance.device_fn``
(``:204-219``, learned statistics: x and x0 both transformed) with
``UniformAcceptor.device_fn`` and the log weight of
``inference/util.py:400-406``; the CUDA kernel is
``csrc/linear_sumstat.cu``. ``params`` is the transform ``{"W": (S, C'),
"b": (C',), "mu": (S,), "sd": (S,)}``, ``w`` the ``(C',)`` feature
weights.

- ``transform_rows(x, params)``: ``(n, S)`` -> ``(n, C')``, s = ((x - mu) /
  sd) @ W + b (the fetch's rows, the record ring under an adaptive
  distance, x0);
- ``linear_accept(ss, x0, params, w, eps, valid, p=, ...)`` -> (distance,
  accept, log weight) of a round: K5's accept on the transformed rows
  against the transformed x0;
- ``linear_accept.values(ss, x0, params, w, p=)`` -> the distances only
  (the reservoir's recompute after a boundary refit), bit-equal on the
  card to the accept's under the same parameters.

Each counts its launches on ``linear_accept`` (the transform too: one
kernel, three entries); ``mode_launches`` splits them (``transform``,
``values``).
"""
from __future__ import annotations

import torch

from ..ops.fit import LINEAR_KEYS, linear_predict
from ..utils import not_ported
from . import _build
from .base import Kernel
from .pnorm_accept import accept_epilogue_plain, expect_terms, pnorm_rows

#: the widest learned feature vector the kernel keeps in registers
MAX_C = 8


def transform_rows_plain(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version of ``transform_rows``."""
    return linear_predict(x, params)


def linear_values_plain(ss, x0, params, w, *, p: float) -> torch.Tensor:
    """Plain PyTorch version of ``linear_accept.values``."""
    s0 = linear_predict(x0[None], params)[0]
    return pnorm_rows(linear_predict(ss, params), s0, w, p)


def linear_accept_plain(ss, x0, params, w, eps, valid, *, p: float,
                        hist_min=None, logpri=None, logq=None,
                        log_offset: float = 0.0):
    """Plain PyTorch version -> (distance, accept, log_weight)."""
    return accept_epilogue_plain(
        linear_values_plain(ss, x0, params, w, p=p), eps, valid,
        hist_min=hist_min, logpri=logpri, logq=logq, log_offset=log_offset)


class LinearAccept(Kernel):
    name = "linear_accept"
    source = "pyabc_tpu_torch/csrc/linear_sumstat.cu"
    replaces = "pyabc_tpu/predictor/predictor.py:125"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"transform": 0, "values": 0}

    def _check_params(self, params: dict, S: int) -> int:
        C = params["b"].shape[0]
        if not 0 < C <= MAX_C:
            raise not_ported(f"learned statistics of {C} features on the "
                             f"card (the transform keeps at most {MAX_C} in "
                             f"registers)", "14")
        f32 = torch.float32
        for k, shape in (("W", (S, C)), ("b", (C,)), ("mu", (S,)),
                         ("sd", (S,))):
            self.expect(params[k], k, f32, shape)
        return C

    def _params(self, params: dict):
        return [params[k] for k in LINEAR_KEYS]

    def transform(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        if self.on_cpu(x, *self._params(params)):
            return transform_rows_plain(x, params)
        n, S = x.shape
        self.expect(x, "x", torch.float32, (n, S))
        C = self._check_params(params, S)
        out = torch.empty(n, C, dtype=torch.float32, device=x.device)
        err = _build.library().pyabc_linear_transform(
            x.data_ptr(), n, S, C, *(t.data_ptr() for t in
                                     self._params(params)),
            out.data_ptr(), _build.stream_ptr(x.device))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches["transform"] += 1
        return out

    def _launch(self, ss, x0, params, w, p, *, values: bool, eps=None,
                valid=None, hist_min=None, logpri=None, logq=None,
                log_offset: float = 0.0):
        B, S = ss.shape
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        C = self._check_params(params, S)
        self.expect(w, "w", f32, (C,))
        dev = ss.device
        d = torch.empty(B, dtype=f32, device=dev)
        accept = lw = None
        if not values:
            expect_terms(self, B, eps, valid, hist_min, logpri, logq, None,
                         None, None)
            accept = torch.empty(B, dtype=torch.bool, device=dev)
            lw = torch.empty(B, dtype=f32, device=dev)
        err = _build.library().pyabc_linear_accept(
            ss.data_ptr(), B, S, C, x0.data_ptr(),
            *(t.data_ptr() for t in self._params(params)), w.data_ptr(),
            float(p), int(values), self.ptr(valid), self.ptr(eps),
            self.ptr(hist_min), self.ptr(logpri), self.ptr(logq),
            float(log_offset), d.data_ptr(), self.ptr(accept), self.ptr(lw),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return d, accept, lw

    def values(self, ss, x0, params: dict, w, *, p: float) -> torch.Tensor:
        if self.on_cpu(ss, x0, w, *self._params(params)):
            return linear_values_plain(ss, x0, params, w, p=p)
        d = self._launch(ss, x0, params, w, p, values=True)[0]
        self.mode_launches["values"] += 1
        return d

    def __call__(self, ss, x0, params: dict, w, eps, valid, *, p: float,
                 hist_min=None, logpri=None, logq=None,
                 log_offset: float = 0.0):
        opt = [t for t in (hist_min, logpri, logq) if t is not None]
        if self.on_cpu(ss, x0, w, eps, valid, *self._params(params), *opt):
            return linear_accept_plain(
                ss, x0, params, w, eps, valid, p=p, hist_min=hist_min,
                logpri=logpri, logq=logq, log_offset=log_offset)
        return self._launch(ss, x0, params, w, p, values=False, eps=eps,
                            valid=valid, hist_min=hist_min, logpri=logpri,
                            logq=logq, log_offset=log_offset)


linear_accept = LinearAccept()


def transform_rows(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``(n, S)`` raw statistics -> ``(n, C')`` learned ones (K23's
    transform entry)."""
    return linear_accept.transform(x, params)
