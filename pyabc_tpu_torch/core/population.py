"""Weighted population container (the ``pyabc_tpu.core.population``
counterpart), struct-of-arrays on the host."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .parameters import ParameterSpace
from .sumstat_spec import SumStatSpec


class Population:
    """One generation's accepted particles.

    Total weight over all models is normalized to 1; model probability
    p(m) is the weight sum of model-m particles; within-model weights are
    w / p(m)."""

    def __init__(self, *, ms: np.ndarray, thetas: np.ndarray,
                 weights: np.ndarray, distances: np.ndarray,
                 sumstats: np.ndarray | None,
                 spaces: Sequence[ParameterSpace],
                 sumstat_spec: SumStatSpec,
                 model_names: Sequence[str] | None = None):
        n = len(ms)
        if not (thetas.shape[0] == n and len(weights) == n
                and len(distances) == n
                and (sumstats is None or sumstats.shape[0] == n)):
            raise ValueError("population arrays disagree in length")
        self.ms = np.asarray(ms, np.int32)
        self.thetas = np.asarray(thetas, np.float64)
        w = np.asarray(weights, np.float64)
        total = w.sum()
        if not np.isfinite(total) or total <= 0:
            raise ValueError(f"population total weight invalid: {total}")
        self.weights = w / total
        self.distances = np.asarray(distances, np.float64)
        self.sumstats = (np.asarray(sumstats, np.float64)
                         if sumstats is not None else None)
        self.spaces = list(spaces)
        self.sumstat_spec = sumstat_spec
        self.model_names = (list(model_names) if model_names is not None
                            else [f"m{m}" for m in range(len(self.spaces))])

    def __len__(self) -> int:
        return len(self.ms)

    def model_probabilities_array(self) -> np.ndarray:
        probs = np.zeros(len(self.spaces))
        np.add.at(probs, self.ms, self.weights)
        return probs

    def get_alive_models(self) -> list[int]:
        return [int(m) for m in np.unique(self.ms)]

    def get_distribution(self, m: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Model m's parameters ``(n_m, dim_m)`` and its weights normalized
        within the model (the host fit's input)."""
        mask = self.ms == m
        if not mask.any():
            raise KeyError(f"no particles for model {m}")
        w = self.weights[mask]
        return self.thetas[mask][:, : self.spaces[m].dim], w / w.sum()

    def get_weighted_distances(self) -> dict:
        """``{"distance", "w"}``: the distances and the population's
        normalized weights (an epsilon's host update reads them)."""
        return {"distance": self.distances, "w": self.weights}

    def __repr__(self):
        return f"Population(n={len(self)}, models={self.get_alive_models()})"
