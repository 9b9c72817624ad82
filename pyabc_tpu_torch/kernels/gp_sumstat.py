"""The GP transform (the host-refit mode's ``GPPredictor``): learned
summary statistics through RBF kernel ridge regression, and the accept
test through them.

Counterpart of ``pyabc_tpu/predictor/predictor.py::GPPredictor.
device_predict`` (``:354``) inside ``distance/pnorm.py::PNormDistance.
device_fn`` (``:204-219``: x and x0 both transformed) with
``UniformAcceptor.device_fn`` and the log weight of
``inference/util.py:400-406``; the CUDA kernel is ``csrc/gp_sumstat.cu``.
``params`` is the transform ``{"X": (cap, S), "a": (cap, C'), "ls": (),
"mu", "sd": (S,), "ymu": (C',)}`` (``GPPredictor.device_params``), ``w``
the ``(C',)`` feature weights.

- ``transform_rows(x, params)``: ``(n, S)`` -> ``(n, C')`` (the record
  ring under an adaptive distance, x0);
- ``gp_accept(ss, x0, params, w, eps, valid, p=, ...)`` -> (distance,
  accept, log weight) of a round: x0 through the GP once, then K5's accept
  on the transformed rows against it;
- ``gp_accept.values(ss, x0, params, w, p=)`` -> the distances only (the
  reservoir's recompute after a boundary refit), bit-equal on the card to
  the accept's under the same parameters.

Each counts its launches on ``gp_accept`` (one kernel source, three
entries); ``mode_launches`` splits them (``transform``, ``values``).
:func:`caps_reason` names a shape beyond the kernel's design; ``ABCSMC``
refuses it when the run starts.
"""
from __future__ import annotations

import torch

from ..ops.fit import GP_KEYS, gp_predict
from . import _build
from .base import Kernel
from .pnorm_accept import accept_epilogue_plain, expect_terms, pnorm_rows

#: the widest raw statistic the kernel stages (csrc/gp_sumstat.cu kMaxS)
MAX_S = 256
#: the most features (csrc/feature_pnorm.cuh kMaxFeatures)
MAX_C = 8


def caps_reason(S: int, C: int) -> str | None:
    """Why the GP kernel cannot take a transform of ``S`` statistics to
    ``C`` features (None: it can). Any ``cap`` runs: the training points
    are walked in tiles."""
    if S > MAX_S:
        return (f"GP transform of {S} statistics (the GP kernel stages at "
                f"most {MAX_S})")
    if C > MAX_C:
        return f"GP transform to {C} features (the kernel keeps {MAX_C})"
    return None


def transform_scale(x: torch.Tensor, params: dict) -> torch.Tensor:
    """The scale a GP transform of the rows ``x`` is held to, ``sum_j |k_j
    a_jc| + |ymu_c|`` in float64 (n, C'): the sum ``k @ a`` cancels where
    the kernel system is ill-conditioned (a small ``alpha``, ``|a|`` far
    above the result), so two float32 orders of it agree relative to this
    scale, not to the result."""
    p64 = {k: v.to(torch.float64) for k, v in params.items()}
    k = gp_predict(x.to(torch.float64),
                   {**p64, "a": p64["a"].abs(),
                    "ymu": torch.zeros_like(p64["ymu"])})
    return k + p64["ymu"].abs()


def distance_scale(ss, x0, params, w) -> torch.Tensor:
    """The scale of a GP accept's distances (B,): ``sum_c w_c (scale_c(x)
    + scale_c(x0))``, which bounds how far a distance moves with its
    transform's rounding for p >= 1."""
    s0 = transform_scale(x0[None], params)[0]
    return (transform_scale(ss, params) + s0) @ w.to(torch.float64).abs()


def transform_rows_plain(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version of ``transform_rows``."""
    return gp_predict(x, params)


def gp_values_plain(ss, x0, params, w, *, p: float) -> torch.Tensor:
    """Plain PyTorch version of ``gp_accept.values``."""
    s0 = gp_predict(x0[None], params)[0]
    return pnorm_rows(gp_predict(ss, params), s0, w, p)


def gp_accept_plain(ss, x0, params, w, eps, valid, *, p: float,
                    hist_min=None, logpri=None, logq=None,
                    log_offset: float = 0.0):
    """Plain PyTorch version -> (distance, accept, log_weight)."""
    return accept_epilogue_plain(
        gp_values_plain(ss, x0, params, w, p=p), eps, valid,
        hist_min=hist_min, logpri=logpri, logq=logq, log_offset=log_offset)


class GpAccept(Kernel):
    name = "gp_accept"
    source = "pyabc_tpu_torch/csrc/gp_sumstat.cu"
    replaces = "pyabc_tpu/predictor/predictor.py:354"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"transform": 0, "values": 0}

    def _operands(self, params: dict, S: int) -> tuple:
        """-> (C', cap, the six tensors in the C entry's order) after the
        checks."""
        cap, C = params["a"].shape
        reason = caps_reason(S, C)
        if reason is not None:
            raise ValueError(f"{self.name}: {reason}")
        f32 = torch.float32
        for k, shape in zip(GP_KEYS, ((cap, S), (cap, C), (), (S,), (S,),
                                      (C,))):
            self.expect(params[k], k, f32, shape)
        return C, cap, [params[k] for k in GP_KEYS]

    def transform(self, x: torch.Tensor, params: dict) -> torch.Tensor:
        leaves = [params[k] for k in GP_KEYS]
        if self.on_cpu(x, *leaves):
            return transform_rows_plain(x, params)
        n, S = x.shape
        self.expect(x, "x", torch.float32, (n, S))
        C, cap, ops = self._operands(params, S)
        out = torch.empty(n, C, dtype=torch.float32, device=x.device)
        err = _build.library().pyabc_gp_transform(
            x.data_ptr(), n, S, C, cap, *(t.data_ptr() for t in ops),
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
        C, cap, ops = self._operands(params, S)
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
        err = _build.library().pyabc_gp_accept(
            ss.data_ptr(), B, S, C, cap, x0.data_ptr(),
            *(t.data_ptr() for t in ops), w.data_ptr(), s0.data_ptr(),
            float(p), int(values), self.ptr(valid), self.ptr(eps),
            self.ptr(hist_min), self.ptr(logpri), self.ptr(logq),
            float(log_offset), d.data_ptr(), self.ptr(accept), self.ptr(lw),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return d, accept, lw

    def values(self, ss, x0, params: dict, w, *, p: float) -> torch.Tensor:
        if self.on_cpu(ss, x0, w, *(params[k] for k in GP_KEYS)):
            return gp_values_plain(ss, x0, params, w, p=p)
        d = self._launch(ss, x0, params, w, p, values=True)[0]
        self.mode_launches["values"] += 1
        return d

    def __call__(self, ss, x0, params: dict, w, eps, valid, *, p: float,
                 hist_min=None, logpri=None, logq=None,
                 log_offset: float = 0.0):
        opt = [t for t in (hist_min, logpri, logq) if t is not None]
        if self.on_cpu(ss, x0, w, eps, valid,
                       *(params[k] for k in GP_KEYS), *opt):
            return gp_accept_plain(
                ss, x0, params, w, eps, valid, p=p, hist_min=hist_min,
                logpri=logpri, logq=logq, log_offset=log_offset)
        return self._launch(ss, x0, params, w, p, values=False, eps=eps,
                            valid=valid, hist_min=hist_min, logpri=logpri,
                            logq=logq, log_offset=log_offset)


gp_accept = GpAccept()


def transform_rows(x: torch.Tensor, params: dict) -> torch.Tensor:
    """``(n, S)`` raw statistics -> ``(n, C')`` learned ones (the GP
    transform's entry)."""
    return gp_accept.transform(x, params)
