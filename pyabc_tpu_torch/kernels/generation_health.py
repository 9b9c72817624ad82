"""K11: the per-generation health word.

Counterpart of ``pyabc_tpu/ops/health.py::generation_health``; the CUDA
kernel is ``csrc/generation_health.cu``. One int32 bitmask
per generation, computed on the device from values the generation step
already holds and read with the chunk's packed fetch (no extra sync). The
bit layout is the JAX package's. ``ops/health.py`` calls this wrapper.

K > 1 (``fitted`` a ``(K,)`` vector, a run over several models): the
parameter sets are stacked over the models and the psd check runs over
each FITTED model's slice (``health.py:80-95``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .base import Kernel

HEALTH_OK = 0
BIT_NAN_THETA = 1 << 0
BIT_NAN_WEIGHT = 1 << 1
BIT_NAN_DISTANCE = 1 << 2
BIT_WEIGHT_ZERO = 1 << 3
BIT_ESS_FLOOR = 1 << 4
BIT_ACC_COLLAPSE = 1 << 5
BIT_EPS_STALL = 1 << 6
BIT_PSD_FAIL = 1 << 7
BIT_EPS_NONFINITE = 1 << 8

BIT_NAMES = (
    "nan_theta", "nan_weight", "nan_distance", "weight_zero",
    "ess_floor", "acc_collapse", "eps_stall", "psd_fail",
    "eps_nonfinite",
)
#: parameter tensors per set the kernel takes
MAX_PARAM_TENSORS = 16


def _bit(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return torch.where(cond, bit, 0).to(torch.int32)


def ess_of(w_norm: torch.Tensor, k_mask: torch.Tensor) -> torch.Tensor:
    w = torch.where(k_mask, w_norm, torch.zeros_like(w_norm))
    return 1.0 / (w * w).sum().clamp_min(1e-38)


def params_unhealthy(params: dict, fitted: torch.Tensor) -> torch.Tensor:
    """True when a FITTED model's proposal params hold non-finite values or
    an all-zero resampling weight vector."""
    finite = torch.ones((), dtype=torch.bool, device=fitted.device)
    for v in params.values():
        if isinstance(v, torch.Tensor):
            finite = finite & torch.isfinite(v).all()
    zero_w = params["weights"].sum() <= 0.0
    return fitted & (~finite | zero_w)


def params_unhealthy_models(params: dict, fitted: torch.Tensor
                            ) -> torch.Tensor:
    """K > 1: ``params_unhealthy`` of each model's slice of stacked
    params, gated by ``fitted (K,)``."""
    bad = torch.zeros((), dtype=torch.bool, device=fitted.device)
    for k in range(fitted.shape[0]):
        one = {key: v[k] for key, v in params.items()
               if isinstance(v, torch.Tensor)}
        bad = bad | params_unhealthy(one, fitted[k])
    return bad


def population_bits(theta, k_mask, w_norm, d_new, n_acc, *,
                    ess_floor: float, n_target: int, acc_rate,
                    acc_floor: float):
    zeros = torch.zeros_like(theta)
    theta_bad = ~torch.isfinite(torch.where(k_mask[:, None], theta,
                                            zeros)).all()
    w_masked = torch.where(k_mask, w_norm, torch.zeros_like(w_norm))
    w_bad = ~torch.isfinite(w_masked).all()
    d_bad = ~torch.isfinite(torch.where(k_mask, d_new,
                                        torch.zeros_like(d_new))).all()
    w_zero = (n_acc > 0) & (w_masked.sum() <= 0.0)
    ess = ess_of(w_norm, k_mask)
    ess_bad = ~(ess >= ess_floor * float(max(n_target, 1)))
    acc_bad = (acc_rate < acc_floor) & (acc_floor > 0.0)
    word = (_bit(theta_bad, BIT_NAN_THETA) | _bit(w_bad, BIT_NAN_WEIGHT)
            | _bit(d_bad, BIT_NAN_DISTANCE) | _bit(w_zero, BIT_WEIGHT_ZERO)
            | _bit(ess_bad, BIT_ESS_FLOOR)
            | _bit(acc_bad, BIT_ACC_COLLAPSE))
    return word, ess


def eps_stall_update(eps_prev, eps_g, stall_count, *, window: int,
                     rtol: float):
    if window <= 0:
        zero = torch.zeros((), dtype=torch.int32, device=eps_g.device)
        return zero, zero
    impr = torch.where(
        torch.isfinite(eps_prev),
        (eps_prev - eps_g) / eps_prev.abs().clamp_min(1e-30),
        torch.ones_like(eps_g),
    )
    count_next = torch.where(impr < rtol, stall_count + 1,
                             torch.zeros_like(stall_count)).to(torch.int32)
    return _bit(count_next >= window, BIT_EPS_STALL), count_next


def generation_health_plain(*, theta, k_mask, w_norm, d_new, n_acc,
                            n_target, acc_rate, trans_params, trans_next,
                            fitted, fitted_next, eps_g, eps_next, eps_prev,
                            stall_count, ess_floor: float, acc_floor: float,
                            stall_window: int, stall_rtol: float):
    """Plain PyTorch version -> (word, ess, eps_prev_next,
    stall_count_next)."""
    word, ess = population_bits(
        theta, k_mask, w_norm, d_new, n_acc, ess_floor=ess_floor,
        n_target=n_target, acc_rate=acc_rate, acc_floor=acc_floor)
    check = params_unhealthy if fitted.dim() == 0 else params_unhealthy_models
    psd_bad = check(trans_params, fitted) | check(trans_next, fitted_next)
    word = word | _bit(psd_bad, BIT_PSD_FAIL)
    eps_bad = ~torch.isfinite(eps_g) | ~torch.isfinite(eps_next)
    word = word | _bit(eps_bad, BIT_EPS_NONFINITE)
    stall_bit, stall_next = eps_stall_update(
        eps_prev, eps_g, stall_count, window=stall_window, rtol=stall_rtol)
    return word | stall_bit, ess, eps_g, stall_next


class GenerationHealth(Kernel):
    name = "generation_health"
    source = "pyabc_tpu_torch/csrc/generation_health.cu"
    replaces = "pyabc_tpu/ops/health.py:159"

    def _param_set(self, params: dict, what: str):
        """(count, pointers, sizes, index of the weights) of a parameter
        dict's tensors; every tensor must be float32 and contiguous."""
        tensors = [(k, v) for k, v in params.items()
                   if isinstance(v, torch.Tensor)]
        if not 0 < len(tensors) <= MAX_PARAM_TENSORS:
            raise ValueError(f"{self.name}: {what} holds {len(tensors)} "
                             f"tensors (1 to {MAX_PARAM_TENSORS})")
        for k, v in tensors:
            self.expect(v, f"{what}.{k}", torch.float32, tuple(v.shape))
        keys = [k for k, _v in tensors]
        if "weights" not in keys:
            raise ValueError(f"{self.name}: {what} has no weights")
        n = len(tensors)
        ptrs = (ctypes.c_void_p * n)(*[v.data_ptr() for _k, v in tensors])
        sizes = (ctypes.c_longlong * n)(*[v.numel() for _k, v in tensors])
        return n, ptrs, sizes, keys.index("weights")

    def __call__(self, *, theta, k_mask, w_norm, d_new, n_acc, n_target,
                 acc_rate, trans_params, trans_next, fitted, fitted_next,
                 eps_g, eps_next, eps_prev, stall_count, ess_floor: float,
                 acc_floor: float, stall_window: int, stall_rtol: float):
        kw = dict(theta=theta, k_mask=k_mask, w_norm=w_norm, d_new=d_new,
                  n_acc=n_acc, n_target=n_target, acc_rate=acc_rate,
                  trans_params=trans_params, trans_next=trans_next,
                  fitted=fitted, fitted_next=fitted_next, eps_g=eps_g,
                  eps_next=eps_next, eps_prev=eps_prev,
                  stall_count=stall_count, ess_floor=ess_floor,
                  acc_floor=acc_floor, stall_window=stall_window,
                  stall_rtol=stall_rtol)
        params = [v for p in (trans_params, trans_next) for v in p.values()
                  if isinstance(v, torch.Tensor)]
        scalars = (n_acc, acc_rate, fitted, fitted_next, eps_g, eps_next,
                   eps_prev, stall_count)
        if self.on_cpu(theta, k_mask, w_norm, d_new, *scalars, *params):
            return generation_health_plain(**kw)
        n_cap, d = theta.shape
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        n_models = fitted.shape[0] if fitted.dim() == 1 else 1
        self.expect(theta, "theta", f32, (n_cap, d))
        self.expect(k_mask, "k_mask", b8, (n_cap,))
        self.expect(w_norm, "w_norm", f32, (n_cap,))
        self.expect(d_new, "d_new", f32, (n_cap,))
        for t, what, dt in ((n_acc, "n_acc", i32), (acc_rate, "acc_rate", f32),
                            (eps_g, "eps_g", f32), (eps_next, "eps_next", f32),
                            (eps_prev, "eps_prev", f32),
                            (stall_count, "stall_count", i32)):
            if t.dtype != dt or t.numel() != 1:
                raise TypeError(f"{self.name}: {what} must be one {dt}, got "
                                f"{t.dtype} {tuple(t.shape)}")
        for t, what in ((fitted, "fitted"), (fitted_next, "fitted_next")):
            if t.dtype != b8 or t.numel() != n_models \
                    or not t.is_contiguous():
                raise TypeError(f"{self.name}: {what} must hold {n_models} "
                                f"bool, got {t.dtype} {tuple(t.shape)}")
        set0 = self._param_set(trans_params, "trans_params")
        set1 = self._param_set(trans_next, "trans_next")
        dev = theta.device
        word = torch.empty((), dtype=i32, device=dev)
        ess = torch.empty((), dtype=f32, device=dev)
        stall_next = torch.empty((), dtype=i32, device=dev)
        # the floors as the plain version compares them: in float32
        ess_min = float(ess_floor) * float(max(int(n_target), 1))
        err = _build.library().pyabc_generation_health(
            theta.data_ptr(), n_cap, d, k_mask.data_ptr(), w_norm.data_ptr(),
            d_new.data_ptr(), n_acc.data_ptr(), acc_rate.data_ptr(),
            *set0, *set1, n_models, fitted.data_ptr(),
            fitted_next.data_ptr(),
            eps_g.data_ptr(), eps_next.data_ptr(), eps_prev.data_ptr(),
            stall_count.data_ptr(), ess_min, float(acc_floor),
            int(stall_window), float(stall_rtol), word.data_ptr(),
            ess.data_ptr(), stall_next.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return word, ess, eps_g, stall_next


generation_health = GenerationHealth()
