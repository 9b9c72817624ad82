"""K18 transformed mode, its per-generation operands.

Counterpart of ``pyabc_tpu/ops/fit.py::linear_bound_prepare`` (reached
from ``distance/pnorm.py::_transformed_bound_fn`` and
``inference/util.py:888-893``); the CUDA kernel is
``csrc/linear_bound.cu``. ``linear_bound(w, params, imap)`` -> ``{"At":
(S, C'), "proj": (n_seg + 1, C', C')}``: the weighted coefficient rows of
a fitted linear transform and the projectors onto the null spaces of the
suffix Grams, which K18's ``LinBound`` (``kernels/segment_round.py``)
folds and tests once a generation's rounds begin.
"""
from __future__ import annotations

import torch

from ..ops.fit import linear_bound_prepare
from . import _build
from .base import Kernel
from .linear_sumstat import MAX_C


def linear_bound_plain(w: torch.Tensor, params: dict,
                       imap: torch.Tensor) -> dict:
    """Plain PyTorch version (``ops/fit.py``: eigh in float64)."""
    return linear_bound_prepare(w, params, imap)


class LinearBound(Kernel):
    name = "linear_bound"
    source = "pyabc_tpu_torch/csrc/linear_bound.cu"
    replaces = "pyabc_tpu/ops/fit.py:186"

    def __call__(self, w: torch.Tensor, params: dict,
                 imap: torch.Tensor) -> dict:
        W, sd = params["W"], params["sd"]
        if self.on_cpu(w, W, sd, imap):
            return linear_bound_plain(w, params, imap)
        S, C = W.shape
        if not 0 < C <= MAX_C:
            raise ValueError(f"{self.name}: at most {MAX_C} features")
        n_seg, seg_size = imap.shape
        f32 = torch.float32
        self.expect(W, "W", f32, (S, C))
        self.expect(sd, "sd", f32, (S,))
        self.expect(w, "w", f32, (C,))
        self.expect(imap, "imap", torch.int32, (n_seg, seg_size))
        dev = W.device
        At = torch.empty(S, C, dtype=f32, device=dev)
        proj = torch.empty(n_seg + 1, C, C, dtype=f32, device=dev)
        err = _build.library().pyabc_linear_bound(
            W.data_ptr(), sd.data_ptr(), w.data_ptr(), imap.data_ptr(), S,
            C, n_seg, seg_size, At.data_ptr(), proj.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return {"At": At, "proj": proj}


linear_bound = LinearBound()
