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
"""
from __future__ import annotations

import torch

from . import _build
from .base import Kernel

MAX_DIM = 16


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


class ProposalDrift(Kernel):
    name = "proposal_drift"
    source = "pyabc_tpu_torch/csrc/proposal_drift.cu"
    replaces = "pyabc_tpu/transition/util.py:109"

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


proposal_drift = ProposalDrift()
