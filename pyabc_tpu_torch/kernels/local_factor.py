"""K13: the changed-row factorization of LocalTransition's covariance field.

Counterpart of ``pyabc_tpu/transition/local_transition.py::_device_factorize``
and the changed-row path of ``device_fit_update``, with
``transition/util.py::device_chol_guarded_batched`` (the jitter ladder per
row) and ``ops/select.py::apply_rowwise_blocked``; the CUDA kernel is
``csrc/local_factor.cu``.

``local_factor(field, prev, dim=..., incremental=...)`` takes K12's field
(``thetas``, ``weights``, ``cdf``, ``covs``) and the carried params and
returns ``(params, n_changed)``: LocalTransition's params ``thetas``,
``weights``, ``chols``, ``precs``, ``logdets``, the ancestor ``cdf`` and the
port-only per-component constant ``lconst = log w - 0.5 (dim log 2 pi +
logdet)`` (0 where w = 0, so every params tensor stays finite for the
health word; K14 skips w = 0), and ``dim``. Incremental: a row whose
covariance is within ``REUSE_RTOL`` (relative to its mean real diagonal)
of ``chol_prev chol_prev^T`` keeps its previous factors; otherwise every
row is factorized. A refit ``flag`` (int32 on the device) that reads 0
carries ``prev`` forward verbatim with n_changed 0; without ``prev`` (K16's
bootstrap fits, whose flag is "the bisection is not done") the kernel then
writes nothing.

``out`` (optional) holds the factor tensors to write (``chols``, ``precs``,
``logdets``, ``lconst``), views of stacked buffers; ``n_changed`` a 0-dim
int32 the kernel adds its count to (one counter over the models of a run
over several models); ``mode`` names the caller in ``mode_launches``
(``"models"``, ``"bootstrap"``).
"""
from __future__ import annotations

import math

import torch

from ..ops.select import apply_rowwise_blocked
from . import _build
from .base import Kernel
from .mvn_fit import CHOL_JITTER_LADDER, _cholesky_or_nan

#: LocalTransition.REUSE_RTOL: the incremental refit's row-reuse tolerance
REUSE_RTOL = 1e-5
MAX_DIM = 16
_LOG_2PI = math.log(2.0 * math.pi)
#: the params tensors a LocalTransition fit holds, in the kernel's order
PARAM_KEYS = ("thetas", "weights", "cdf", "chols", "precs", "logdets",
              "lconst")


def device_chol_guarded_batched(covs: torch.Tensor):
    """Batched jitter-ladder Cholesky of an (n, d, d) field: each row takes
    the first rung whose factor is finite -> (chols, covs_used,
    psd_failed_any). All rungs are computed, so nothing waits on the
    device."""
    d = covs.shape[-1]
    chols = _cholesky_or_nan(covs)
    used = covs
    tr = (torch.diagonal(covs, dim1=-2, dim2=-1).sum(-1) / d).clamp_min(
        1e-30)[..., None, None]
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    for jit in CHOL_JITTER_LADDER:
        bad = ~torch.isfinite(chols).all(dim=-1).all(dim=-1)
        bad = bad[..., None, None]
        cov_j = covs + eye * (jit * tr)
        chols = torch.where(bad, _cholesky_or_nan(cov_j), chols)
        used = torch.where(bad, cov_j, used)
    return chols, used, ~torch.isfinite(chols).all()


def changed_rows_plain(covs: torch.Tensor, prev_chols: torch.Tensor,
                       dim: int) -> torch.Tensor:
    """max |cov - Lp Lp^T| over the real block > REUSE_RTOL max(sum of the
    real diagonal / dim, 1e-30), each operation in the kernel's order."""
    n, d, _ = covs.shape
    old = prev_chols[:, :, None, 0] * prev_chols[:, None, :, 0]
    for j in range(1, d):
        old = old + prev_chols[:, :, None, j] * prev_chols[:, None, :, j]
    diff = (covs - old)[:, :dim, :dim].abs().amax(dim=(1, 2))
    s = covs[:, 0, 0]
    for k in range(1, dim):
        s = s + covs[:, k, k]
    scale = (s / torch.tensor(float(dim), dtype=s.dtype,
                              device=s.device)).clamp_min(1e-30)
    return diff > REUSE_RTOL * scale


def factorize_plain(covs: torch.Tensor, dim: int):
    """(chols, precs, logdets) of a batch of covariances: the ladder, the
    precision of the covariance used (``inv_ex``, as the JAX package's LU
    inverse) and 2 sum_{k < dim} log max(L_kk, 1e-38), masked to the real
    block."""
    d = covs.shape[-1]
    vmask = (torch.arange(d, device=covs.device) < dim).to(covs.dtype)
    outer = vmask[:, None] * vmask[None, :]
    chols, used, _bad = device_chol_guarded_batched(covs)
    precs = torch.linalg.inv_ex(used)[0] * outer
    logdets = 2.0 * (vmask * torch.log(torch.diagonal(
        chols, dim1=-2, dim2=-1).clamp_min(1e-38))).sum(-1)
    return chols * outer, precs, logdets


def lconst_of(w: torch.Tensor, logdets: torch.Tensor, dim: int):
    """log w - 0.5 (dim log 2 pi + logdet) where w > 0, else 0."""
    c = torch.log(w) - 0.5 * (float(dim) * _LOG_2PI + logdets)
    return torch.where(w > 0, c, torch.zeros_like(c))


def local_factor_plain(field: dict, prev: dict | None, *, dim: int,
                       incremental: bool,
                       flag: torch.Tensor | None = None,
                       out: dict | None = None,
                       n_changed: torch.Tensor | None = None):
    """Plain PyTorch version -> (params, n_changed); a flag without
    ``prev`` is ignored (the field is factorized whatever it reads)."""
    flagged = flag is not None and prev is not None
    res, count = _local_factor_plain(field, prev, dim=dim,
                                     incremental=incremental,
                                     flag=flag if flagged else None)
    if flagged:
        # as the kernel: the field's thetas, weights and cdf are the params'
        # and take the carried ones when the flag reads 0
        for k in ("thetas", "weights", "cdf"):
            field[k].copy_(res[k])
            res[k] = field[k]
    if out is not None:
        for k, v in out.items():
            v.copy_(res[k])
        res.update(out)
    if n_changed is not None:
        n_changed.add_(count.to(n_changed.dtype))
        count = n_changed
    return res, count


def _local_factor_plain(field: dict, prev: dict | None, *, dim: int,
                        incremental: bool,
                        flag: torch.Tensor | None = None):
    covs, w = field["covs"], field["weights"]
    n, d, _ = covs.shape
    if prev is None:
        prev = {"chols": torch.zeros_like(covs),
                "precs": torch.zeros_like(covs),
                "logdets": torch.zeros_like(w)}
    changed = (changed_rows_plain(covs, prev["chols"], dim) if incremental
               else torch.ones(n, dtype=torch.bool, device=covs.device))
    (chols, precs, logdets), n_changed = apply_rowwise_blocked(
        lambda c: factorize_plain(c, dim), changed,
        (prev["chols"], prev["precs"], prev["logdets"]), covs)
    params = {"thetas": field["thetas"], "weights": w, "cdf": field["cdf"],
              "chols": chols.contiguous(), "precs": precs.contiguous(),
              "logdets": logdets.contiguous(),
              "lconst": lconst_of(w, logdets, dim).contiguous()}
    if flag is not None:
        keep = flag != 0
        params = {k: torch.where(keep, v, prev[k]).contiguous()
                  for k, v in params.items()}
        n_changed = torch.where(keep, n_changed, torch.zeros_like(n_changed))
    return {**params, "dim": float(dim)}, n_changed


#: the factor tensors K13 writes
FACTOR_KEYS = ("chols", "precs", "logdets", "lconst")


class LocalFactor(Kernel):
    name = "local_factor"
    source = "pyabc_tpu_torch/csrc/local_factor.cu"
    replaces = "pyabc_tpu/transition/local_transition.py:309"
    #: callers counted on their own, each also in ``launches``
    MODES = ("models", "bootstrap")

    def __init__(self):
        super().__init__()
        self.mode_launches = {m: 0 for m in self.MODES}

    def __call__(self, field: dict, prev: dict | None, *, dim: int,
                 incremental: bool, flag: torch.Tensor | None = None,
                 out: dict | None = None,
                 n_changed: torch.Tensor | None = None,
                 mode: str | None = None):
        if incremental and prev is None:
            raise ValueError(f"{self.name}: an incremental refit needs the "
                             f"previous params")
        if mode is not None and mode not in self.MODES:
            raise ValueError(f"{self.name}: mode {mode!r} not one of "
                             f"{self.MODES}")
        ins = [field[k] for k in ("thetas", "weights", "cdf", "covs")]
        prev_t = [] if prev is None else [prev[k] for k in PARAM_KEYS]
        extra = [t for t in (flag, n_changed) if t is not None]
        if self.on_cpu(*ins, *prev_t, *extra):
            return local_factor_plain(field, prev, dim=dim,
                                      incremental=incremental, flag=flag,
                                      out=out, n_changed=n_changed)
        n, d, _ = field["covs"].shape
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"cap {MAX_DIM}")
        f32 = torch.float32
        shapes = {"thetas": (n, d), "weights": (n,), "cdf": (n,),
                  "chols": (n, d, d), "precs": (n, d, d), "logdets": (n,),
                  "lconst": (n,)}
        self.expect(field["covs"], "covs", f32, (n, d, d))
        for k in ("thetas", "weights", "cdf"):
            self.expect(field[k], k, f32, shapes[k])
        if prev is not None:
            for k in PARAM_KEYS:
                self.expect(prev[k], f"prev.{k}", f32, shapes[k])
        if flag is not None:
            self.expect(flag, "flag", torch.int32, ())
        dev = field["covs"].device
        given = out or {}
        out = {}
        for k in FACTOR_KEYS:
            if k in given:
                self.expect(given[k], f"out.{k}", f32, shapes[k])
                out[k] = given[k]
            else:
                out[k] = torch.empty(shapes[k], dtype=f32, device=dev)
        if n_changed is None:
            n_changed = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            self.expect(n_changed, "n_changed", torch.int32, ())
        prev_ptrs = ([None] * 7 if prev is None
                     else [prev[k].data_ptr() for k in PARAM_KEYS])
        err = _build.library().pyabc_local_factor(
            n, d, int(dim), field["covs"].data_ptr(), *prev_ptrs,
            int(bool(incremental)), REUSE_RTOL, self.ptr(flag),
            field["thetas"].data_ptr(), field["weights"].data_ptr(),
            field["cdf"].data_ptr(),
            *(out[k].data_ptr() for k in FACTOR_KEYS),
            n_changed.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] += 1
        params = {"thetas": field["thetas"], "weights": field["weights"],
                  "cdf": field["cdf"], **out, "dim": float(dim)}
        return params, n_changed


local_factor = LocalFactor()
