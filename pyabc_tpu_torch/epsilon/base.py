"""Epsilon schedules (``pyabc_tpu/epsilon/base.py`` counterpart).

On the fused path a quantile schedule's values are computed on the device
each generation (weighted quantile of the accepted distances,
``ops/stats.py``); the host objects keep the trail as it is fetched, for
History and resume. The per-generation host loop calls the host
``initialize`` and ``update`` instead, which take the quantile in float64
numpy (``weighted_quantile``).
"""
from __future__ import annotations

import numpy as np


def weighted_quantile(points, weights=None, alpha: float = 0.5) -> float:
    """The alpha-quantile of weighted ``points`` (float64): sort the
    points, take the first whose cumulative normalized weight reaches
    alpha (a lower step quantile, no interpolation)."""
    points = np.asarray(points, dtype=np.float64)
    if weights is None:
        weights = np.ones_like(points)
    weights = np.asarray(weights, dtype=np.float64)
    if points.shape != weights.shape:
        raise ValueError("points and weights must have identical shape")
    order = np.argsort(points, kind="stable")
    points = points[order]
    cum = np.cumsum(weights[order])
    total = cum[-1]
    if not np.isfinite(total) or total <= 0:
        raise ValueError("weights must sum to a positive finite value")
    idx = int(np.searchsorted(cum / total, alpha))
    return float(points[min(idx, len(points) - 1)])


class Epsilon:
    def initialize(self, t: int, get_weighted_distances=None,
                   get_all_records=None, max_nr_populations=None,
                   acceptor_config=None) -> None:
        """The host loop's start of the schedule at generation t."""

    def update(self, t: int, get_weighted_distances=None,
               get_all_records=None, acceptance_rate=None,
               acceptor_config=None) -> None:
        """The host loop's threshold of generation t, from generation t -
        1's population."""

    def configure_sampler(self, sampler) -> None:
        pass

    def requires_calibration(self) -> bool:
        return False

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def __repr__(self):
        return f"{type(self).__name__}()"


class ConstantEpsilon(Epsilon):
    def __init__(self, constant_epsilon_value: float):
        self.constant_epsilon_value = float(constant_epsilon_value)

    def __call__(self, t: int) -> float:
        return self.constant_epsilon_value

    def get_config(self):
        return {"name": type(self).__name__,
                "constant_epsilon_value": self.constant_epsilon_value}


class ListEpsilon(Epsilon):
    def __init__(self, values):
        self.epsilon_values = [float(v) for v in values]

    def __call__(self, t: int) -> float:
        return self.epsilon_values[t]

    def get_config(self):
        return {"name": type(self).__name__,
                "epsilon_values": self.epsilon_values}


class QuantileEpsilon(Epsilon):
    """alpha-quantile of the previous generation's (weighted) accepted
    distances; ``initial_epsilon`` is a float or ``"from_sample"`` (the
    quantile of the calibration sample)."""

    def __init__(self, initial_epsilon: float | str = "from_sample",
                 alpha: float = 0.5, quantile_multiplier: float = 1.0,
                 weighted: bool = True):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        self.initial_epsilon = initial_epsilon
        self.alpha = float(alpha)
        self.quantile_multiplier = float(quantile_multiplier)
        self.weighted = bool(weighted)
        self._values: dict[int, float] = {}

    def requires_calibration(self) -> bool:
        return self.initial_epsilon == "from_sample"

    def initialize(self, t, get_weighted_distances=None,
                   get_all_records=None, max_nr_populations=None,
                   acceptor_config=None):
        if self.initial_epsilon == "from_sample":
            if get_weighted_distances is None:
                raise ValueError("QuantileEpsilon('from_sample') needs "
                                 "calibration distances")
            self._set(t, get_weighted_distances())
        else:
            self._values[t] = float(self.initial_epsilon)

    def update(self, t, get_weighted_distances=None, get_all_records=None,
               acceptance_rate=None, acceptor_config=None):
        if get_weighted_distances is None:
            raise ValueError("QuantileEpsilon.update needs weighted "
                             "distances")
        self._set(t, get_weighted_distances())

    def _set(self, t: int, df) -> None:
        """``df``: ``{"distance": ..., "w": ...}`` (the weights optional)."""
        distances = np.asarray(df["distance"], np.float64)
        weights = (np.asarray(df["w"], np.float64)
                   if self.weighted and "w" in df
                   else np.ones_like(distances))
        val = weighted_quantile(distances, weights, alpha=self.alpha)
        self._values[t] = float(val * self.quantile_multiplier)

    def __call__(self, t: int) -> float:
        if t == 0 and not self.requires_calibration():
            return float(self.initial_epsilon)
        try:
            return self._values[t]
        except KeyError:
            raise KeyError(f"no epsilon value for generation {t} (have "
                           f"{sorted(self._values)})") from None

    def get_config(self):
        return {"name": type(self).__name__, "alpha": self.alpha,
                "quantile_multiplier": self.quantile_multiplier,
                "weighted": self.weighted}

    def __repr__(self):
        return f"{type(self).__name__}(alpha={self.alpha})"


class MedianEpsilon(QuantileEpsilon):
    def __init__(self, initial_epsilon: float | str = "from_sample",
                 quantile_multiplier: float = 1.0, weighted: bool = True):
        super().__init__(initial_epsilon, alpha=0.5,
                         quantile_multiplier=quantile_multiplier,
                         weighted=weighted)

