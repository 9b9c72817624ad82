"""K15: the drift guard of LocalTransition's refit cadence, with the cadence
decision in the same launch.

Counterpart of ``pyabc_tpu/transition/util.py::device_proposal_drift`` and
the refit decision of ``pyabc_tpu/inference/util.py:1959-1997`` (one
model); the CUDA kernel is ``csrc/proposal_drift.cu``. The decision stays
in device memory: K12 and K13 read ``flag`` and return at once when it is
0, so the cadence adds no host sync.

``proposal_drift(fit_thetas, fit_w, new_thetas, new_w, k_mask, ...)``
returns ``drift`` (f32), ``refit`` (bool: the cadence's decision),
``flag`` (int32: refit and at least ``min_count`` accepted rows, the refit
K12/K13 run), ``gens_since`` (int32, the next generation's counter) and
``fitted`` (bool, the next generation's). ``every=1`` refits every
generation (the cadence off).

K > 1 mode (``proposal_drift.models``, ``util.py:1958-1987``): each
model's drift against its own carried fit, where the model was fitted and
accepted rows, the maximum over the models; the forced refit of a model
with rows and no fit; per model ``flag`` and ``fitted`` ``(K,)``, and the
refit's masked weights ``w_models (K, n)`` (``where(m == k, w_norm, 0)``,
K12's input). Counted in ``mode_launches["models"]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .base import Kernel

MAX_DIM = 16
#: models the K > 1 mode's statics hold
MAX_MODELS = 8


def device_proposal_drift(fit_thetas: torch.Tensor, fit_w: torch.Tensor,
                          new_thetas: torch.Tensor, new_w: torch.Tensor,
                          vmask: torch.Tensor) -> torch.Tensor:
    """Weighted drift of the new population against the fitted one: per
    real dim the mean shift in fitted sds and the relative variance change,
    their maximum; 0 when either side has no mass."""
    sf, sn = fit_w.sum(), new_w.sum()
    wf = fit_w / sf.clamp_min(1e-38)
    wn = new_w / sn.clamp_min(1e-38)
    mu_f, mu_n = wf @ fit_thetas, wn @ new_thetas
    var_f = (wf @ (fit_thetas ** 2) - mu_f ** 2).clamp_min(0.0)
    var_n = (wn @ (new_thetas ** 2) - mu_n ** 2).clamp_min(0.0)
    denom = var_f + 1e-12 + 1e-8 * mu_f ** 2
    mean_shift = (mu_n - mu_f).abs() / torch.sqrt(denom)
    var_shift = (var_n - var_f).abs() / denom
    drift = (torch.maximum(mean_shift, var_shift) * vmask).max()
    return torch.where((sf > 0) & (sn > 0), drift, torch.zeros_like(drift))


def proposal_drift_plain(fit_thetas, fit_w, new_thetas, new_w, k_mask, *,
                         dim: int, fitted: torch.Tensor,
                         gens_since: torch.Tensor, every: int, thr: float,
                         min_count: int) -> dict:
    """Plain PyTorch version."""
    d = new_thetas.shape[1]
    vmask = (torch.arange(d, device=new_thetas.device) < dim).to(
        new_thetas.dtype)
    count = k_mask.sum()
    drift = device_proposal_drift(fit_thetas, fit_w, new_thetas, new_w,
                                  vmask)
    drift = torch.where(fitted & (count > 0), drift, torch.zeros_like(drift))
    tick = gens_since + 1
    refit = (tick >= every) | (drift > thr) | ~fitted
    flag = refit & (count >= min_count)
    return {"drift": drift, "refit": refit, "flag": flag.to(torch.int32),
            "gens_since": torch.where(refit, torch.zeros_like(tick),
                                      tick).to(torch.int32),
            "fitted": flag | (fitted & (count > 0))}


def proposal_drift_models_plain(fit_thetas, fit_w, new_thetas, w_norm,
                                k_mask, m, *, dims, fitted: torch.Tensor,
                                gens_since: torch.Tensor, every: int,
                                thr: float, min_counts) -> dict:
    """Plain PyTorch version of the K > 1 mode."""
    K = fit_thetas.shape[0]
    d = new_thetas.shape[1]
    dev = new_thetas.device
    zero = torch.zeros((), dtype=new_thetas.dtype, device=dev)
    drifts, counts, w_models = [], [], []
    for k in range(K):
        vmask = (torch.arange(d, device=dev) < dims[k]).to(new_thetas.dtype)
        mine = m == k
        w_new = torch.where(mine & k_mask, w_norm, torch.zeros_like(w_norm))
        count = (mine & k_mask).sum()
        d_k = device_proposal_drift(fit_thetas[k], fit_w[k], new_thetas,
                                    w_new, vmask)
        drifts.append(torch.where(fitted[k] & (count > 0), d_k, zero))
        counts.append(count)
        w_models.append(torch.where(mine, w_norm, torch.zeros_like(w_norm)))
    drift = torch.stack(drifts).max()
    counts = torch.stack(counts)
    tick = gens_since + 1
    refit = ((tick >= every) | (drift > thr) | (~fitted & (counts > 0)).any()
             | ~fitted.any())
    mins = torch.tensor([int(c) for c in min_counts], device=dev)
    flag = refit & (counts >= mins)
    return {"drift": drift, "refit": refit, "flag": flag.to(torch.int32),
            "gens_since": torch.where(refit, torch.zeros_like(tick),
                                      tick).to(torch.int32),
            "fitted": flag | (fitted & (counts > 0)),
            "w_models": torch.stack(w_models).contiguous()}


class ProposalDrift(Kernel):
    name = "proposal_drift"
    source = "pyabc_tpu_torch/csrc/proposal_drift.cu"
    replaces = "pyabc_tpu/transition/util.py:109"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"models": 0}

    def __call__(self, fit_thetas: torch.Tensor, fit_w: torch.Tensor,
                 new_thetas: torch.Tensor, new_w: torch.Tensor,
                 k_mask: torch.Tensor, *, dim: int, fitted: torch.Tensor,
                 gens_since: torch.Tensor, every: int, thr: float,
                 min_count: int) -> dict:
        kw = dict(dim=dim, fitted=fitted, gens_since=gens_since,
                  every=every, thr=thr, min_count=min_count)
        if self.on_cpu(fit_thetas, fit_w, new_thetas, new_w, k_mask, fitted,
                       gens_since):
            return proposal_drift_plain(fit_thetas, fit_w, new_thetas, new_w,
                                        k_mask, **kw)
        nf, d = fit_thetas.shape
        n = new_thetas.shape[0]
        if d > MAX_DIM:
            raise ValueError(f"{self.name}: dim {d} above the kernel's "
                             f"cap {MAX_DIM}")
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.expect(fit_thetas, "fit_thetas", f32, (nf, d))
        self.expect(fit_w, "fit_w", f32, (nf,))
        self.expect(new_thetas, "new_thetas", f32, (n, d))
        self.expect(new_w, "new_w", f32, (n,))
        self.expect(k_mask, "k_mask", b8, (n,))
        self.expect(fitted, "fitted", b8, ())
        self.expect(gens_since, "gens_since", i32, ())
        dev = new_thetas.device
        out = {"drift": torch.empty((), dtype=f32, device=dev),
               "refit": torch.empty((), dtype=b8, device=dev),
               "flag": torch.empty((), dtype=i32, device=dev),
               "gens_since": torch.empty((), dtype=i32, device=dev),
               "fitted": torch.empty((), dtype=b8, device=dev)}
        err = _build.library().pyabc_proposal_drift(
            fit_thetas.data_ptr(), fit_w.data_ptr(), nf,
            new_thetas.data_ptr(), new_w.data_ptr(), k_mask.data_ptr(), n,
            d, int(dim), int(min_count), fitted.data_ptr(),
            gens_since.data_ptr(), int(every), float(thr),
            *(out[k].data_ptr() for k in ("drift", "refit", "flag",
                                          "gens_since", "fitted")),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out

    def models(self, fit_thetas: torch.Tensor, fit_w: torch.Tensor,
               new_thetas: torch.Tensor, w_norm: torch.Tensor,
               k_mask: torch.Tensor, m: torch.Tensor, *, dims,
               fitted: torch.Tensor, gens_since: torch.Tensor, every: int,
               thr: float, min_counts) -> dict:
        """The K > 1 mode: ``fit_thetas (K, nf, d)``, ``fit_w (K, nf)``
        (the stacked carried fits), the reservoir's ``new_thetas (n, d)``,
        ``w_norm``, ``k_mask`` and ``m (n,)``; ``dims`` and ``min_counts``
        per model; ``fitted (K,)`` -> ``drift``, ``refit``, ``gens_since``
        (0-dim), ``flag (K,)`` int32, ``fitted (K,)`` and ``w_models (K,
        n)``."""
        kw = dict(dims=dims, fitted=fitted, gens_since=gens_since,
                  every=every, thr=thr, min_counts=min_counts)
        if self.on_cpu(fit_thetas, fit_w, new_thetas, w_norm, k_mask, m,
                       fitted, gens_since):
            return proposal_drift_models_plain(fit_thetas, fit_w,
                                               new_thetas, w_norm, k_mask,
                                               m, **kw)
        K, nf, d = fit_thetas.shape
        n = new_thetas.shape[0]
        if (d > MAX_DIM or not 0 < K <= MAX_MODELS or len(dims) != K
                or len(min_counts) != K):
            raise ValueError(f"{self.name}: dim {d} (cap {MAX_DIM}), {K} "
                             f"models (cap {MAX_MODELS}) or the per-model "
                             f"statics do not match")
        f32, i32, b8 = torch.float32, torch.int32, torch.bool
        self.expect(fit_thetas, "fit_thetas", f32, (K, nf, d))
        self.expect(fit_w, "fit_w", f32, (K, nf))
        self.expect(new_thetas, "new_thetas", f32, (n, d))
        self.expect(w_norm, "w_norm", f32, (n,))
        self.expect(k_mask, "k_mask", b8, (n,))
        self.expect(m, "m", i32, (n,))
        self.expect(fitted, "fitted", b8, (K,))
        self.expect(gens_since, "gens_since", i32, ())
        dev = new_thetas.device
        out = {"drift": torch.empty((), dtype=f32, device=dev),
               "refit": torch.empty((), dtype=b8, device=dev),
               "flag": torch.empty(K, dtype=i32, device=dev),
               "gens_since": torch.empty((), dtype=i32, device=dev),
               "fitted": torch.empty(K, dtype=b8, device=dev),
               "w_models": torch.empty(K, n, dtype=f32, device=dev)}
        err = _build.library().pyabc_proposal_drift_models(
            fit_thetas.data_ptr(), fit_w.data_ptr(), nf,
            new_thetas.data_ptr(), w_norm.data_ptr(), k_mask.data_ptr(),
            m.data_ptr(), n, d, K,
            (ctypes.c_int * K)(*[int(x) for x in dims]),
            (ctypes.c_int * K)(*[int(x) for x in min_counts]),
            fitted.data_ptr(), gens_since.data_ptr(), int(every),
            float(thr),
            *(out[k].data_ptr() for k in ("drift", "refit", "flag",
                                          "gens_since", "fitted",
                                          "w_models")),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        self.mode_launches["models"] += 1
        return out


proposal_drift = ProposalDrift()
