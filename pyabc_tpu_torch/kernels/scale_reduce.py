"""K9: the adaptive distance refit of a generation step.

Counterpart of ``pyabc_tpu/distance/pnorm.py::AdaptivePNormDistance``'s
``device_record_reduce`` and ``device_weight_update``,
``distance/scale.py::_device_scale_impls`` (all 13 built-in scale
functions) and the distance recompute under the new weights
(``pyabc_tpu/inference/util.py:1847``); the CUDA kernels are in
``csrc/scale_reduce.cu`` with the radix selection of ``csrc/select.cuh``.

One call reduces the UNMASKED ``samples (n, S)`` under ``valid (n,)``
against ``x0 (S,)`` to the ``(S,)`` scale, turns it into weights (1/scale,
the ``max_weight_ratio`` clip, mean-1 normalization) and, given ``rows``,
computes their weighted p-norm distances under the new weights.
"""
from __future__ import annotations

import torch

from . import _build
from .base import Kernel
from .pnorm_accept import pnorm_rows
from .select import workspace

#: the scale functions, in the order of the kernel's codes
SCALE_NAMES = (
    "median_absolute_deviation", "mean_absolute_deviation",
    "standard_deviation", "span", "mean", "median", "bias",
    "root_mean_square_deviation",
    "median_absolute_deviation_to_observation",
    "mean_absolute_deviation_to_observation",
    "combined_median_absolute_deviation",
    "combined_mean_absolute_deviation",
    "standard_deviation_to_observation",
)


# ------------------------------------------------------------ plain version
def nanmedian_plain(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(x, 0.5, axis=0)`` with its linear method, in the
    same float32 steps: NaN left out, q = 0.5 (count - 1), the two order
    statistics at floor(q) and ceil(q), low (1 - hw) + high hw."""
    s = torch.sort(x, dim=0).values  # NaN sorts last
    c = (~torch.isnan(x)).sum(0).to(torch.float32)
    q = 0.5 * (c - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    hw = q - lo
    zero = torch.zeros_like(q)
    lo_i = torch.maximum(zero, torch.minimum(lo, c - 1.0)).long()
    hi_i = torch.maximum(zero, torch.minimum(hi, c - 1.0)).long()
    low = s.gather(0, lo_i[None])[0]
    high = s.gather(0, hi_i[None])[0]
    return low * (1.0 - hw) + high * hw


def _masked(samples, valid):
    return torch.where(valid[:, None], samples,
                       torch.full_like(samples, torch.nan))


def _count(valid):
    return valid.sum().clamp_min(1).to(torch.float32)


def _sum_valid(x, valid):
    return torch.where(valid[:, None], x, torch.zeros_like(x)).sum(0)


def _mean(samples, valid):
    return _sum_valid(samples, valid) / _count(valid)


def _std(samples, valid):
    mu = _mean(samples, valid)
    return torch.sqrt(_sum_valid((samples - mu) ** 2, valid) / _count(valid))


def _mad(samples, valid, x_0):
    m = _masked(samples, valid)
    return nanmedian_plain((m - nanmedian_plain(m)).abs())


def _mean_ad(samples, valid, x_0):
    mu = _mean(samples, valid)
    return _sum_valid((samples - mu).abs(), valid) / _count(valid)


def _span(samples, valid, x_0):
    big = torch.where(valid[:, None], samples,
                      torch.full_like(samples, -torch.inf)).max(0).values
    small = torch.where(valid[:, None], samples,
                        torch.full_like(samples, torch.inf)).min(0).values
    return big - small


def _bias(samples, valid, x_0):
    return (_mean(samples, valid) - x_0).abs()


def _rmsd(samples, valid, x_0):
    b = _bias(samples, valid, x_0)
    s = _std(samples, valid)
    return torch.sqrt(b * b + s * s)


def _mad_to_obs(samples, valid, x_0):
    return nanmedian_plain((_masked(samples, valid) - x_0).abs())


def _mean_ad_to_obs(samples, valid, x_0):
    return _sum_valid((samples - x_0).abs(), valid) / _count(valid)


def _combined_mad(samples, valid, x_0):
    return _mad(samples, valid, x_0) + (
        nanmedian_plain(_masked(samples, valid)) - x_0).abs()


def _combined_mean_ad(samples, valid, x_0):
    return _mean_ad(samples, valid, x_0) + (
        _mean(samples, valid) - x_0).abs()


def _std_to_obs(samples, valid, x_0):
    return torch.sqrt(_sum_valid((samples - x_0) ** 2, valid)
                      / _count(valid))


#: plain twins of the scale functions, keyed by name
SCALES_PLAIN = {
    "median_absolute_deviation": _mad,
    "mean_absolute_deviation": _mean_ad,
    "standard_deviation": lambda s, v, x0: _std(s, v),
    "span": _span,
    "mean": lambda s, v, x0: _mean(s, v),
    "median": lambda s, v, x0: nanmedian_plain(_masked(s, v)),
    "bias": _bias,
    "root_mean_square_deviation": _rmsd,
    "median_absolute_deviation_to_observation": _mad_to_obs,
    "mean_absolute_deviation_to_observation": _mean_ad_to_obs,
    "combined_median_absolute_deviation": _combined_mad,
    "combined_mean_absolute_deviation": _combined_mean_ad,
    "standard_deviation_to_observation": _std_to_obs,
}


def weight_update_plain(scale: torch.Tensor, max_weight_ratio: float | None,
                        normalize_weights: bool) -> torch.Tensor:
    """1/scale (0 where scale <= 0), optional ratio clip, mean-1
    normalization."""
    pos = scale > 0
    w = torch.where(pos, 1.0 / torch.where(pos, scale,
                                           torch.ones_like(scale)),
                    torch.zeros_like(scale))
    if max_weight_ratio is not None:
        wmin = torch.where(w > 0, w, torch.full_like(w, torch.inf)).min()
        w = torch.minimum(w, wmin * max_weight_ratio)
    if normalize_weights:
        s = w.sum()
        w = torch.where(s > 0, w * (w.numel() / torch.where(
            s > 0, s, torch.ones_like(s))), w)
    return w


def scale_reduce_plain(samples, valid, x0, *, scale_name: str,
                       max_weight_ratio: float | None = None,
                       normalize_weights: bool = True, rows=None,
                       p: float = 2.0):
    """Plain PyTorch version -> (scale, weights, distances of ``rows`` or
    None)."""
    scale = SCALES_PLAIN[scale_name](samples, valid, x0)
    w = weight_update_plain(scale, max_weight_ratio, normalize_weights)
    d = None if rows is None else pnorm_rows(rows, x0, w, p)
    return scale, w, d


class ScaleReduce(Kernel):
    name = "scale_reduce"
    source = "pyabc_tpu_torch/csrc/scale_reduce.cu"
    replaces = "pyabc_tpu/distance/scale.py:113"

    def __call__(self, samples, valid, x0, *, scale_name: str,
                 max_weight_ratio: float | None = None,
                 normalize_weights: bool = True, rows=None, p: float = 2.0):
        extra = [] if rows is None else [rows]
        if self.on_cpu(samples, valid, x0, *extra):
            return scale_reduce_plain(
                samples, valid, x0, scale_name=scale_name,
                max_weight_ratio=max_weight_ratio,
                normalize_weights=normalize_weights, rows=rows, p=p)
        if scale_name not in SCALE_NAMES:
            raise NotImplementedError(f"{self.name}: no kernel for the "
                                      f"scale function {scale_name!r}")
        if max_weight_ratio is not None and not max_weight_ratio > 0:
            raise ValueError(f"{self.name}: max_weight_ratio must be > 0")
        n, S = samples.shape
        f32 = torch.float32
        self.expect(samples, "samples", f32, (n, S))
        self.expect(valid, "valid", torch.bool, (n,))
        self.expect(x0, "x0", f32, (S,))
        n_rows = 0
        if rows is not None:
            n_rows = rows.shape[0]
            self.expect(rows, "rows", f32, (n_rows, S))
        dev = samples.device
        ws = workspace(S, 2, False, dev)
        stats = torch.empty(8 * S, dtype=f32, device=dev)
        scale = torch.empty(S, dtype=f32, device=dev)
        w = torch.empty(S, dtype=f32, device=dev)
        d = None if rows is None else torch.empty(n_rows, dtype=f32,
                                                  device=dev)
        err = _build.library().pyabc_scale_reduce(
            samples.data_ptr(), n, S, valid.data_ptr(), x0.data_ptr(),
            SCALE_NAMES.index(scale_name),
            float(max_weight_ratio or 0.0), int(bool(normalize_weights)),
            self.ptr(rows), n_rows, float(p), ws.data_ptr(),
            stats.data_ptr(), scale.data_ptr(), w.data_ptr(), self.ptr(d),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return scale, w, d


scale_reduce = ScaleReduce()
