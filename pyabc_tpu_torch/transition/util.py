"""Transition utilities (``pyabc_tpu/transition/util.py`` counterpart):
bandwidth rules and the device Cholesky with its jitter-escalation ladder
(part of K8 in ROADMAP queue B, plain PyTorch)."""
from __future__ import annotations

import torch


def scott_rule_of_thumb(n_samples, dimension: int):
    """Scott bandwidth factor n^(-1/(d+4)) (floats or tensors)."""
    return n_samples ** (-1.0 / (dimension + 4))


def silverman_rule_of_thumb(n_samples, dimension: int):
    """Silverman factor (4/(d+2))^(1/(d+4)) n^(-1/(d+4))."""
    return (4 / (dimension + 2)) ** (1 / (dimension + 4)) * n_samples ** (
        -1 / (dimension + 4))


#: escalating relative diagonal-jitter ladder of the device Cholesky
CHOL_JITTER_LADDER = (1e-10, 1e-7, 1e-4)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where the factorization fails (jnp semantics;
    no host sync, unlike ``torch.linalg.cholesky``)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.full_like(chol, torch.nan))


def device_chol_guarded(cov: torch.Tensor):
    """-> (chol, cov_used, psd_failed): the first rung of the jitter ladder
    (scaled by the mean diagonal) whose factor is finite. All rungs are
    computed unconditionally, so nothing waits on the device."""
    d = cov.shape[-1]
    chol = _cholesky_or_nan(cov)
    cov_used = cov
    tr = (torch.trace(cov) / d).clamp_min(1e-30)
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    for jit in CHOL_JITTER_LADDER:
        bad = ~torch.isfinite(chol).all()
        cov_j = cov + eye * (jit * tr)
        chol = torch.where(bad, _cholesky_or_nan(cov_j), chol)
        cov_used = torch.where(bad, cov_j, cov_used)
    return chol, cov_used, ~torch.isfinite(chol).all()
