"""K23 transform (the MLP plan): learned summary statistics through a tanh
MLP, and the accept test through them.

Counterpart of ``pyabc_tpu/predictor/predictor.py::MLPPredictor.
device_predict`` (``:272``, ``ops/fit.py::_mlp_forward`` ``:102``) inside
``distance/pnorm.py::PNormDistance.device_fn`` (``:204-219``: x and x0
both transformed) with ``UniformAcceptor.device_fn`` and the log weight of
``inference/util.py:400-406``; the CUDA kernel is
``csrc/mlp_sumstat.cu``. ``params`` is the transform ``{"layers": [{"w",
"b"}, ...], "mu", "sd", "ymu", "ysd"}``, ``w`` the ``(C',)`` feature
weights.

- ``transform_rows(x, params)``: ``(n, S)`` -> ``(n, C')`` (the fetch's
  rows, the record ring under an adaptive distance, x0);
- ``mlp_accept(ss, x0, params, w, eps, valid, p=, ...)`` -> (distance,
  accept, log weight) of a round: x0 through the MLP once, then K5's
  accept on the transformed rows against it;
- ``mlp_accept.values(ss, x0, params, w, p=)`` -> the distances only (the
  reservoir's recompute after a boundary refit), bit-equal on the card to
  the accept's under the same parameters.

Each counts its launches on ``mlp_accept`` (one kernel source, three
entries); ``mode_launches`` splits them (``transform``, ``values``).
"""
from __future__ import annotations

import torch

from ..ops.fit import (MLP_KEYS, mlp_predict, mlp_sizes, pack_layers,
                       param_leaves)
from . import _build
from .base import Kernel
from .mlp_fit import check_caps, widths_arg
from .pnorm_accept import accept_epilogue_plain, expect_terms, pnorm_rows


def transform_rows_plain(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version of ``transform_rows``."""
    return mlp_predict(x, params)


def mlp_values_plain(ss, x0, params, w, *, p: float) -> torch.Tensor:
    """Plain PyTorch version of ``mlp_accept.values``."""
    s0 = mlp_predict(x0[None], params)[0]
    return pnorm_rows(mlp_predict(ss, params), s0, w, p)


def mlp_accept_plain(ss, x0, params, w, eps, valid, *, p: float,
                     hist_min=None, logpri=None, logq=None,
                     log_offset: float = 0.0):
    """Plain PyTorch version -> (distance, accept, log_weight)."""
    return accept_epilogue_plain(
        mlp_values_plain(ss, x0, params, w, p=p), eps, valid,
        hist_min=hist_min, logpri=logpri, logq=logq, log_offset=log_offset)


class MlpAccept(Kernel):
    name = "mlp_accept"
    source = "pyabc_tpu_torch/csrc/mlp_sumstat.cu"
    replaces = "pyabc_tpu/predictor/predictor.py:272"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"transform": 0, "values": 0}

    def _operands(self, params: dict, S: int):
        """-> (the host widths array, its address, depth, the packed
        layers, mu, sd, ymu, ysd) after the checks."""
        sizes = mlp_sizes(params["layers"])
        check_caps(sizes)
        C = sizes[-1]
        if sizes[0] != S:
            raise ValueError(f"{self.name}: the MLP takes {sizes[0]} "
                             f"statistics, the rows have {S}")
        f32 = torch.float32
        for k, n in zip(MLP_KEYS, (S, S, C, C)):
            self.expect(params[k], k, f32, (n,))
        arr, widths = widths_arg(sizes)
        return (arr, widths, len(sizes) - 1, pack_layers(params["layers"]),
                *(params[k] for k in MLP_KEYS))

    def transform(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        if self.on_cpu(x, *param_leaves(params)):
            return transform_rows_plain(x, params)
        n, S = x.shape
        self.expect(x, "x", torch.float32, (n, S))
        arr, widths, depth, flat, *stats = self._operands(params, S)
        C = stats[2].shape[0]
        out = torch.empty(n, C, dtype=torch.float32, device=x.device)
        err = _build.library().pyabc_mlp_transform(
            x.data_ptr(), n, widths, depth, flat.data_ptr(),
            *(t.data_ptr() for t in stats), out.data_ptr(),
            _build.stream_ptr(x.device))
        del arr
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
        arr, widths, depth, flat, *stats = self._operands(params, S)
        C = stats[2].shape[0]
        self.expect(w, "w", f32, (C,))
        dev = ss.device
        d = torch.empty(B, dtype=f32, device=dev)
        s0 = torch.empty(C, dtype=f32, device=dev)
        accept = lw = None
        if not values:
            expect_terms(self, B, eps, valid, hist_min, logpri, logq, None,
                         None, None)
            accept = torch.empty(B, dtype=torch.bool, device=dev)
            lw = torch.empty(B, dtype=f32, device=dev)
        err = _build.library().pyabc_mlp_accept(
            ss.data_ptr(), B, widths, depth, x0.data_ptr(), flat.data_ptr(),
            *(t.data_ptr() for t in stats), w.data_ptr(), s0.data_ptr(),
            float(p), int(values), self.ptr(valid), self.ptr(eps),
            self.ptr(hist_min), self.ptr(logpri), self.ptr(logq),
            float(log_offset), d.data_ptr(), self.ptr(accept), self.ptr(lw),
            _build.stream_ptr(dev))
        del arr
        _build.check(err, self.name)
        self.launches += 1
        return d, accept, lw

    def values(self, ss, x0, params: dict, w, *, p: float) -> torch.Tensor:
        if self.on_cpu(ss, x0, w, *param_leaves(params)):
            return mlp_values_plain(ss, x0, params, w, p=p)
        d = self._launch(ss, x0, params, w, p, values=True)[0]
        self.mode_launches["values"] += 1
        return d

    def __call__(self, ss, x0, params: dict, w, eps, valid, *, p: float,
                 hist_min=None, logpri=None, logq=None,
                 log_offset: float = 0.0):
        opt = [t for t in (hist_min, logpri, logq) if t is not None]
        if self.on_cpu(ss, x0, w, eps, valid, *param_leaves(params), *opt):
            return mlp_accept_plain(
                ss, x0, params, w, eps, valid, p=p, hist_min=hist_min,
                logpri=logpri, logq=logq, log_offset=log_offset)
        return self._launch(ss, x0, params, w, p, values=False, eps=eps,
                            valid=valid, hist_min=hist_min, logpri=logpri,
                            logq=logq, log_offset=log_offset)


mlp_accept = MlpAccept()


def transform_rows(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``(n, S)`` raw statistics -> ``(n, C')`` learned ones (the MLP
    transform's entry)."""
    return mlp_accept.transform(x, params)
