"""Per-generation health word (``pyabc_tpu/ops/health.py`` counterpart,
plain PyTorch; K11 in ROADMAP queue B).

One int32 bitmask per generation, computed on the device from values the
generation step already holds and read with the chunk's packed fetch (no
extra sync). The bit layout is the JAX package's.
"""
from __future__ import annotations

import torch

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


def decode(word: int) -> list[str]:
    return [name for i, name in enumerate(BIT_NAMES) if word & (1 << i)]


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


def generation_health(*, theta, k_mask, w_norm, d_new, n_acc, n_target,
                      acc_rate, trans_params, trans_next, fitted,
                      fitted_next, eps_g, eps_next, eps_prev, stall_count,
                      ess_floor: float, acc_floor: float,
                      stall_window: int, stall_rtol: float):
    """-> (word, ess, eps_prev_next, stall_count_next), single model."""
    word, ess = population_bits(
        theta, k_mask, w_norm, d_new, n_acc, ess_floor=ess_floor,
        n_target=n_target, acc_rate=acc_rate, acc_floor=acc_floor)
    psd_bad = params_unhealthy(trans_params, fitted) \
        | params_unhealthy(trans_next, fitted_next)
    word = word | _bit(psd_bad, BIT_PSD_FAIL)
    eps_bad = ~torch.isfinite(eps_g) | ~torch.isfinite(eps_next)
    word = word | _bit(eps_bad, BIT_EPS_NONFINITE)
    stall_bit, stall_next = eps_stall_update(
        eps_prev, eps_g, stall_count, window=stall_window, rtol=stall_rtol)
    return word | stall_bit, ess, eps_g, stall_next
