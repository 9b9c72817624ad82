"""Epsilon schedules (``pyabc_tpu/epsilon/base.py`` counterpart).

A quantile schedule's values are computed on the device each generation
(weighted quantile of the accepted distances, ``ops/stats.py``); the host
objects keep the trail as it is fetched, for History and resume.
"""
from __future__ import annotations


class Epsilon:
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

