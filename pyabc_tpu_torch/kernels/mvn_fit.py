"""K8: the MultivariateNormalTransition refit of a generation step.

Counterpart of ``pyabc_tpu/transition/multivariatenormal.py::device_fit``
with ``transition/util.py::device_chol_guarded`` (the jitter ladder); the
CUDA kernel is ``csrc/mvn_fit.cu``. The fitted params are a dict of device
tensors: ``thetas``, ``weights``, ``chol``, ``prec``, ``center``,
``thetas_c``, ``quad``, ``logdet``, the ancestor ``cdf`` that K2 searches
and the true ``dim`` (a Python float).
"""
from __future__ import annotations

from typing import Callable

import torch

from . import _build
from .base import Kernel

#: escalating relative diagonal-jitter ladder of the device Cholesky
CHOL_JITTER_LADDER = (1e-10, 1e-7, 1e-4)
#: register cap of the kernel's dim buckets (the K3 buckets)
MAX_DIM = 32
#: bandwidth rules the kernel knows, by the function's name
SELECTORS = {"scott_rule_of_thumb": 0, "silverman_rule_of_thumb": 1}


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor; where the factorization fails, NaN on and below
    the diagonal and 0 above, as ``jnp.linalg.cholesky`` (no host sync,
    unlike ``torch.linalg.cholesky``)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol,
                       torch.tril(torch.full_like(chol, torch.nan)))


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


def ancestor_cdf_plain(w: torch.Tensor) -> torch.Tensor:
    """cummax(where(w > 0, cumsum(w), 0)): zero-weight rows (empty
    reservoir slots) repeat the previous row's cdf, so K2's search never
    lands on them, and cummax keeps the cdf monotone whatever order the
    scan summed in."""
    return torch.cummax(torch.where(w > 0, torch.cumsum(w, 0),
                                    torch.zeros_like(w)), 0).values


def mvn_fit_plain(thetas: torch.Tensor, weights: torch.Tensor, *, dim: int,
                  scaling: float, bandwidth_selector: Callable) -> dict:
    """Plain PyTorch version: weighted mean/cov (smart_cov guard),
    bandwidth from the ESS, jitter-ladder Cholesky, precision, logdet, the
    centred cache and the ancestor cdf."""
    d_max = thetas.shape[1]
    vmask = (torch.arange(d_max, device=thetas.device) < dim).to(
        thetas.dtype)
    w = weights / weights.sum().clamp_min(1e-38)
    mean = w @ thetas
    centered = thetas - mean
    cov = (centered * w[:, None]).T @ centered
    diag = torch.diagonal(cov)
    fill = mean.abs() * 1e-4 + 1e-8
    cov = cov + torch.diag(torch.where(diag <= 0, fill - diag,
                                       torch.zeros_like(diag)))
    ess = 1.0 / (w * w).sum().clamp_min(1e-38)
    factor = bandwidth_selector(ess, dim)
    cov = cov * (scaling * factor) ** 2
    chol, cov, _bad = device_chol_guarded(cov)
    prec, _info = torch.linalg.inv_ex(cov)
    logdet = 2.0 * (vmask * torch.log(
        torch.diagonal(chol).clamp_min(1e-38))).sum()
    outer = vmask[:, None] * vmask[None, :]
    prec = (prec * outer).contiguous()
    th = thetas * vmask[None, :]
    center = mean * vmask
    th_c = (th - center[None, :]).contiguous()
    return {
        "thetas": th.contiguous(),
        "weights": w.contiguous(),
        "chol": (chol * outer).contiguous(),
        "prec": prec,
        "center": center.contiguous(),
        "thetas_c": th_c,
        "quad": ((th_c @ prec) * th_c).sum(dim=1).contiguous(),
        "logdet": logdet,
        "cdf": ancestor_cdf_plain(w).contiguous(),
        "dim": float(dim),
    }


class MvnFit(Kernel):
    name = "mvn_fit"
    source = "pyabc_tpu_torch/csrc/mvn_fit.cu"
    replaces = "pyabc_tpu/transition/multivariatenormal.py:130"

    def __call__(self, thetas: torch.Tensor, weights: torch.Tensor, *,
                 dim: int, scaling: float,
                 bandwidth_selector: Callable) -> dict:
        if self.on_cpu(thetas, weights):
            return mvn_fit_plain(thetas, weights, dim=dim, scaling=scaling,
                                 bandwidth_selector=bandwidth_selector)
        n, d = thetas.shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"cap {MAX_DIM}")
        selector = SELECTORS.get(getattr(bandwidth_selector, "__name__", ""))
        if selector is None:
            raise NotImplementedError(
                f"{self.name}: bandwidth rule {bandwidth_selector!r} has no "
                f"kernel (scott or silverman)")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (n, d))
        self.expect(weights, "weights", f32, (n,))
        dev = thetas.device
        out = {
            "thetas": torch.empty(n, d, dtype=f32, device=dev),
            "weights": torch.empty(n, dtype=f32, device=dev),
            "chol": torch.empty(d, d, dtype=f32, device=dev),
            "prec": torch.empty(d, d, dtype=f32, device=dev),
            "center": torch.empty(d, dtype=f32, device=dev),
            "thetas_c": torch.empty(n, d, dtype=f32, device=dev),
            "quad": torch.empty(n, dtype=f32, device=dev),
            "logdet": torch.empty((), dtype=f32, device=dev),
            "cdf": torch.empty(n, dtype=f32, device=dev),
        }
        sel_const = (4 / (dim + 2)) ** (1 / (dim + 4))
        err = _build.library().pyabc_mvn_fit(
            thetas.data_ptr(), weights.data_ptr(), n, d, int(dim),
            float(scaling), selector, sel_const, -1.0 / (dim + 4),
            *(out[k].data_ptr() for k in (
                "thetas", "weights", "chol", "prec", "center", "thetas_c",
                "quad", "logdet", "cdf")),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return {**out, "dim": float(dim)}


mvn_fit = MvnFit()


def chol_guarded_cuda(cov: torch.Tensor):
    """Card check of the kernel's ladder alone on a ``(d, d)`` CUDA matrix
    -> (chol, cov_used, rung) with rung 0-3, or 4 when every rung failed.
    Not on the main path (``mvn_fit`` runs the ladder inline)."""
    d = cov.shape[0]
    if cov.device.type != "cuda" or not 0 < d <= MAX_DIM:
        raise ValueError("chol_guarded_cuda needs a (d, d) CUDA matrix, "
                         f"d <= {MAX_DIM}")
    cov = cov.to(torch.float32).contiguous()
    chol = torch.empty_like(cov)
    used = torch.empty_like(cov)
    rung = torch.empty(1, dtype=torch.int32, device=cov.device)
    err = _build.library().pyabc_chol_guarded(
        cov.data_ptr(), d, chol.data_ptr(), used.data_ptr(), rung.data_ptr(),
        _build.stream_ptr(cov.device))
    _build.check(err, "chol_guarded")
    return chol, used, rung
