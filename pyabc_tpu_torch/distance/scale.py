"""Scale functions for adaptive distance re-weighting
(``pyabc_tpu/distance/scale.py`` counterpart).

The numpy functions are the user-facing names (``AdaptivePNormDistance(
scale_function=standard_deviation)``); each has a device twin that reduces
the UNMASKED record ring ``samples (n, S)`` under ``valid (n,)`` against
``x_0 (S,)`` to an ``(S,)`` scale vector, all on the device: the K9
wrapper (``kernels/scale_reduce.py``).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from ..kernels.scale_reduce import SCALE_NAMES, scale_reduce


#: scale functions whose adaptive refit is a reduction over per-column
#: moments (``pyabc_tpu/ops/scale_reduce.py::SHARDED_SCALE_NAMES``): the
#: ones the JAX package's segmented engine refits over resolved lanes
MOMENT_SCALE_NAMES = frozenset({
    "mean", "bias", "span", "standard_deviation",
    "root_mean_square_deviation",
    "mean_absolute_deviation_to_observation",
    "standard_deviation_to_observation",
})


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
def _device_scale(name: str, samples, valid, x_0):
    return scale_reduce(samples, valid, x_0, scale_name=name,
                        normalize_weights=False)[0]


#: device twin of each built-in scale function: the K9 wrapper
DEVICE_SCALES = {name: partial(_device_scale, name) for name in SCALE_NAMES}


def device_scale_fn(scale_function):
    """The device twin of a built-in scale function, or None (a custom
    function shadowing a built-in name has no twin)."""
    name = getattr(scale_function, "__name__", "")
    if SCALE_FUNCTIONS.get(name) is not scale_function:
        return None
    return DEVICE_SCALES[name]
