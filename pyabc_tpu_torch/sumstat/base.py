"""Summary-statistic transforms (``pyabc_tpu/sumstat/base.py``
counterpart).

A Sumstat maps the flat raw statistics of a particle to the features the
distance compares. ``PredictorSumstat`` learns that map (Fearnhead-Prangle:
s(x) = E[theta | x]): until its first fit it is the identity, then the
fitted predictor. The port runs the linear and the MLP plans: the host
seed fit after generation 0 (``update``; the MLP's Adam steps run on the
card), then K23's refit on the card at each chunk's boundary, its
parameters mirrored back here after the chunk's fetch
(``sumstat/device.py::mirror_fitted_params``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..predictor import Predictor


class Sumstat:
    """The identity."""

    def update(self, t: int, population=None) -> bool:
        """Refit on a generation's population; True if the transform
        changed."""
        return False

    def out_dim(self, in_dim: int) -> int:
        return in_dim

    def __call__(self, flat: np.ndarray) -> np.ndarray:
        """Host transform of a flat (S,) or (n, S) array."""
        return np.asarray(flat, np.float64)

    def __repr__(self):
        return f"{type(self).__name__}()"


class IdentitySumstat(Sumstat):
    """Raw statistics, optionally expanded through elementwise ``trafos``
    (the JAX package serves it in its host-refit mode)."""

    def __init__(self, trafos: Sequence[Callable] | None = None):
        self.trafos = list(trafos) if trafos is not None else None

    def out_dim(self, in_dim: int) -> int:
        return in_dim * (len(self.trafos) if self.trafos else 1)

    def __call__(self, flat: np.ndarray) -> np.ndarray:
        flat = np.asarray(flat, np.float64)
        if not self.trafos:
            return flat
        return np.concatenate([np.asarray(tr(flat)) for tr in self.trafos],
                              axis=-1)

    def __repr__(self):
        n = len(self.trafos) if self.trafos else 1
        return f"IdentitySumstat(trafos={n})"


class PredictorSumstat(Sumstat):
    """Learned statistics s(x) = the predicted theta; ``fit_every`` the
    refit cadence (1: every chunk boundary on the device path),
    ``min_samples`` the rows a fit needs (None: S + 2)."""

    def __init__(self, predictor: Predictor, normalize_labels: bool = True,
                 fit_every: int = 1, min_samples: int | None = None):
        self.predictor = predictor
        self.normalize_labels = normalize_labels
        self.fit_every = int(fit_every)
        self.min_samples = min_samples
        self._out_dim: int | None = None
        self._last_fit_t: int | None = None

    def out_dim(self, in_dim: int) -> int:
        return self._out_dim if self._out_dim is not None else in_dim

    def need(self, in_dim: int) -> int:
        """The rows a fit needs: ``min_samples``, else S + 2."""
        return (int(self.min_samples) if self.min_samples is not None
                else in_dim + 2)

    def update(self, t: int, population=None) -> bool:
        """The host fit on a population's raw statistics, thetas and
        weights (float64), as the JAX package's ``update``."""
        if population is None:
            return False
        if (self._last_fit_t is not None
                and t - self._last_fit_t < self.fit_every):
            return False
        x = np.asarray(population.sumstats, np.float64)
        y = np.asarray(population.thetas, np.float64)
        w = np.asarray(population.weights, np.float64)
        if len(x) < self.need(x.shape[1]):
            return False
        self.predictor.fit(x, y, w)
        self._out_dim = y.shape[1]
        self._last_fit_t = t
        return True

    def __call__(self, flat: np.ndarray) -> np.ndarray:
        if not self.predictor.fitted:
            return np.asarray(flat, np.float64)
        return np.asarray(self.predictor.predict(flat), np.float64)

    def device_params(self, device=None) -> dict | None:
        """The fitted transform's float32 tensors, None before the first
        fit (the identity)."""
        if not self.predictor.fitted:
            return None
        return self.predictor.device_params(device)

    def __repr__(self):
        return f"PredictorSumstat({self.predictor!r})"
