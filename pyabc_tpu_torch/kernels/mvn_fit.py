"""K8: the MultivariateNormalTransition refit of a generation step.

Counterpart of ``pyabc_tpu/transition/multivariatenormal.py::device_fit``
with ``transition/util.py::device_chol_guarded`` (the jitter ladder); the
CUDA kernel is ``csrc/mvn_fit.cu``. The fitted params are a dict of device
tensors: ``thetas``, ``weights``, ``chol``, ``prec``, ``center``,
``thetas_c``, ``quad``, ``logdet``, the ancestor ``cdf`` that K2 searches
and the true ``dim`` (a Python float).

K > 1 mode (``mvn_fit.models``, a run over several models,
``util.py:1908-1948``): model k is refit on the shared d_max-padded
reservoir with ``w_k = where(m == k, weights, 0)`` and its own dim,
scaling and bandwidth rule. It is one launch with a grid of K blocks,
writing stacked params: each tensor with a leading model axis, and
``dims (K,)`` float32 the models' true dims in place of ``dim``.
"""
from __future__ import annotations

import ctypes
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
    unlike ``torch.linalg.cholesky``); a batch fails row by row."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], chol,
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


def precision_of_factor(chol: torch.Tensor) -> torch.Tensor:
    """P = L^-T L^-1 from the factor, as the kernel forms it: a covariance
    that only the ladder's last rung factorizes is singular in float32, so
    an LU inverse of it can come back infinite where the factor's inverse
    stays finite and agrees with the logdet."""
    eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return linv.transpose(-1, -2) @ linv


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
    bandwidth from the ESS, jitter-ladder Cholesky, precision from the
    factor, logdet, the centred cache and the ancestor cdf."""
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
    prec = precision_of_factor(chol)
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


#: models one launch of the K > 1 mode fits (the kernel's statics table)
MAX_MODELS = 8
#: the stacked params' tensors, in the kernel's output order
STACKED_KEYS = ("thetas", "weights", "chol", "prec", "center", "thetas_c",
                "quad", "logdet", "cdf")


def mvn_fit_models_plain(thetas: torch.Tensor, weights: torch.Tensor,
                         m: torch.Tensor, *, dims, statics,
                         dims_tensor: torch.Tensor | None = None) -> dict:
    """Plain PyTorch version of the K > 1 mode: one ``mvn_fit_plain`` per
    model on its masked weights, stacked."""
    fits = [mvn_fit_plain(thetas, torch.where(m == k, weights,
                                              torch.zeros_like(weights)),
                          dim=dims[k], **statics[k])
            for k in range(len(dims))]
    out = {k: torch.stack([f[k] for f in fits]).contiguous()
           for k in STACKED_KEYS}
    out["dims"] = (dims_tensor if dims_tensor is not None else
                   torch.tensor([float(x) for x in dims],
                                dtype=torch.float32, device=thetas.device))
    return out


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

    def models(self, thetas: torch.Tensor, weights: torch.Tensor,
               m: torch.Tensor, *, dims, statics,
               dims_tensor: torch.Tensor | None = None) -> dict:
        """The K > 1 mode: ``dims`` and ``statics`` (each model's
        ``scaling`` and ``bandwidth_selector``) are per-model host values;
        ``dims_tensor`` the models' dims as a float32 device tensor, which
        the stacked params carry (built once by the caller, so no call
        copies to the device)."""
        extra = [dims_tensor] if dims_tensor is not None else []
        if self.on_cpu(thetas, weights, m, *extra):
            return mvn_fit_models_plain(thetas, weights, m, dims=dims,
                                        statics=statics,
                                        dims_tensor=dims_tensor)
        n, d = thetas.shape
        K = len(dims)
        if d > MAX_DIM or not 0 < K <= MAX_MODELS or len(statics) != K:
            raise ValueError(f"{self.name}: dim {d} (cap {MAX_DIM}) or "
                             f"{K} models (cap {MAX_MODELS}) outside the "
                             f"kernel's range")
        sel = [SELECTORS.get(getattr(st["bandwidth_selector"], "__name__",
                                     "")) for st in statics]
        if None in sel:
            raise NotImplementedError(
                f"{self.name}: a bandwidth rule has no kernel (scott or "
                f"silverman)")
        f32 = torch.float32
        self.expect(thetas, "thetas", f32, (n, d))
        self.expect(weights, "weights", f32, (n,))
        self.expect(m, "m", torch.int32, (n,))
        if dims_tensor is None:
            dims_tensor = torch.tensor([float(x) for x in dims], dtype=f32,
                                       device=thetas.device)
        self.expect(dims_tensor, "dims_tensor", f32, (K,))
        dev = thetas.device
        shapes = {"thetas": (K, n, d), "weights": (K, n), "chol": (K, d, d),
                  "prec": (K, d, d), "center": (K, d),
                  "thetas_c": (K, n, d), "quad": (K, n), "logdet": (K,),
                  "cdf": (K, n)}
        out = {k: torch.empty(shapes[k], dtype=f32, device=dev)
               for k in STACKED_KEYS}

        def arr(ctype, vals):
            return (ctype * K)(*vals)

        c_int, c_float = ctypes.c_int, ctypes.c_float
        err = _build.library().pyabc_mvn_fit_models(
            thetas.data_ptr(), weights.data_ptr(), m.data_ptr(), K, n, d,
            arr(c_int, [int(x) for x in dims]),
            arr(c_float, [float(st["scaling"]) for st in statics]),
            arr(c_int, sel),
            arr(c_float, [(4 / (x + 2)) ** (1 / (x + 4)) for x in dims]),
            arr(c_float, [-1.0 / (x + 4) for x in dims]),
            *(out[k].data_ptr() for k in STACKED_KEYS),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return {**out, "dims": dims_tensor}


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
