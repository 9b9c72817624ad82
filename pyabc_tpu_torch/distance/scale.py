"""Scale functions for adaptive distance re-weighting
(``pyabc_tpu/distance/scale.py`` counterpart).

The numpy functions are the user-facing names (``AdaptivePNormDistance(
scale_function=standard_deviation)``); each has a device twin that reduces
the UNMASKED record ring ``samples (n, S)`` under ``valid (n,)`` against
``x_0 (S,)`` to an ``(S,)`` scale vector, all on the device (part of K9 in
ROADMAP queue B, plain PyTorch).
"""
from __future__ import annotations

import numpy as np
import torch


def median_absolute_deviation(samples, x_0=None):
    med = np.median(samples, axis=0)
    return np.median(np.abs(samples - med), axis=0)


def mean_absolute_deviation(samples, x_0=None):
    return np.mean(np.abs(samples - np.mean(samples, axis=0)), axis=0)


def standard_deviation(samples, x_0=None):
    return np.std(samples, axis=0)


def span(samples, x_0=None):
    return np.max(samples, axis=0) - np.min(samples, axis=0)


def mean(samples, x_0=None):
    return np.mean(samples, axis=0)


def median(samples, x_0=None):
    return np.median(samples, axis=0)


def bias(samples, x_0):
    return np.abs(np.mean(samples, axis=0) - x_0)


def root_mean_square_deviation(samples, x_0):
    b = bias(samples, x_0)
    s = standard_deviation(samples)
    return np.sqrt(b * b + s * s)


def median_absolute_deviation_to_observation(samples, x_0):
    return np.median(np.abs(samples - x_0), axis=0)


def mean_absolute_deviation_to_observation(samples, x_0):
    return np.mean(np.abs(samples - x_0), axis=0)


def combined_median_absolute_deviation(samples, x_0):
    return median_absolute_deviation(samples) + np.abs(
        np.median(samples, axis=0) - x_0)


def combined_mean_absolute_deviation(samples, x_0):
    return mean_absolute_deviation(samples) + np.abs(
        np.mean(samples, axis=0) - x_0)


def standard_deviation_to_observation(samples, x_0):
    return np.sqrt(np.mean((samples - x_0) ** 2, axis=0))


SCALE_FUNCTIONS = {
    f.__name__: f
    for f in [
        median_absolute_deviation, mean_absolute_deviation,
        standard_deviation, span, mean, median, bias,
        root_mean_square_deviation,
        median_absolute_deviation_to_observation,
        mean_absolute_deviation_to_observation,
        combined_median_absolute_deviation,
        combined_mean_absolute_deviation,
        standard_deviation_to_observation,
    ]
}


# ------------------------------------------------------------ device twins
def _masked(samples, valid):
    return torch.where(valid[:, None], samples,
                       torch.full_like(samples, torch.nan))


def _nanmedian(x):
    return torch.nanquantile(x, 0.5, dim=0)


def _count(valid):
    return valid.sum().clamp_min(1).to(torch.float32)


def _mean(samples, valid):
    return torch.where(valid[:, None], samples,
                       torch.zeros_like(samples)).sum(0) / _count(valid)


def _std(samples, valid):
    mu = _mean(samples, valid)
    sq = torch.where(valid[:, None], (samples - mu) ** 2,
                     torch.zeros_like(samples))
    return torch.sqrt(sq.sum(0) / _count(valid))


def _mad(samples, valid, x_0):
    m = _masked(samples, valid)
    return _nanmedian((m - _nanmedian(m)).abs())


def _mean_ad(samples, valid, x_0):
    mu = _mean(samples, valid)
    return torch.where(valid[:, None], (samples - mu).abs(),
                       torch.zeros_like(samples)).sum(0) / _count(valid)


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
    return _nanmedian((_masked(samples, valid) - x_0).abs())


def _mean_ad_to_obs(samples, valid, x_0):
    return torch.where(valid[:, None], (samples - x_0).abs(),
                       torch.zeros_like(samples)).sum(0) / _count(valid)


def _combined_mad(samples, valid, x_0):
    return _mad(samples, valid, x_0) + (
        _nanmedian(_masked(samples, valid)) - x_0).abs()


def _combined_mean_ad(samples, valid, x_0):
    return _mean_ad(samples, valid, x_0) + (
        _mean(samples, valid) - x_0).abs()


def _std_to_obs(samples, valid, x_0):
    sq = torch.where(valid[:, None], (samples - x_0) ** 2,
                     torch.zeros_like(samples))
    return torch.sqrt(sq.sum(0) / _count(valid))


DEVICE_SCALES = {
    "median_absolute_deviation": _mad,
    "mean_absolute_deviation": _mean_ad,
    "standard_deviation": lambda s, v, x0: _std(s, v),
    "span": _span,
    "mean": lambda s, v, x0: _mean(s, v),
    "median": lambda s, v, x0: _nanmedian(_masked(s, v)),
    "bias": _bias,
    "root_mean_square_deviation": _rmsd,
    "median_absolute_deviation_to_observation": _mad_to_obs,
    "mean_absolute_deviation_to_observation": _mean_ad_to_obs,
    "combined_median_absolute_deviation": _combined_mad,
    "combined_mean_absolute_deviation": _combined_mean_ad,
    "standard_deviation_to_observation": _std_to_obs,
}


def device_scale_fn(scale_function):
    """The device twin of a built-in scale function, or None (a custom
    function shadowing a built-in name has no twin)."""
    name = getattr(scale_function, "__name__", "")
    if SCALE_FUNCTIONS.get(name) is not scale_function:
        return None
    return DEVICE_SCALES[name]
