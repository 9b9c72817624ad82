"""Model-index perturbation kernel of a run over several models
(``pyabc_tpu/transition/model_perturbation.py`` counterpart).

With probability ``probability_to_stay`` the proposal keeps the ancestor's
model index, otherwise it jumps uniformly to one of the other models. On
the device the matrix is a ``(K, K)`` float32 tensor: K2 draws the
perturbed model from its row of the ancestor by inverse CDF on the MODEL
Philox stream, and K26 (``kernels/model_step.py``) masks it to the fitted
models and renormalizes its rows between generations.
"""
from __future__ import annotations

import numpy as np


class ModelPerturbationKernel:
    def __init__(self, nr_of_models: int,
                 probability_to_stay: float | None = None):
        self.nr_of_models = int(nr_of_models)
        if probability_to_stay is None:
            self.probability_to_stay = 1.0 if nr_of_models == 1 else 0.7
        else:
            self.probability_to_stay = float(np.clip(probability_to_stay,
                                                      0, 1))

    def _transition_matrix(self) -> np.ndarray:
        """P[m, m'] = pmf of proposing m' from ancestor m."""
        K = self.nr_of_models
        if K == 1:
            return np.ones((1, 1))
        stay = self.probability_to_stay
        off = (1.0 - stay) / (K - 1)
        P = np.full((K, K), off)
        np.fill_diagonal(P, stay)
        return P

    def rvs(self, m: int, rng: np.random.Generator | None = None) -> int:
        """A model index proposed from ancestor ``m``."""
        if not 0 <= m < self.nr_of_models:
            raise ValueError(f"model index {m} out of range")
        rng = rng if rng is not None else np.random.default_rng()
        return int(rng.choice(self.nr_of_models,
                              p=self._transition_matrix()[m]))

    def pmf(self, n: int, m: int) -> float:
        """Probability of proposing n given ancestor m."""
        if not (0 <= n < self.nr_of_models and 0 <= m < self.nr_of_models):
            raise ValueError("model index out of range")
        return float(self._transition_matrix()[m, n])

    def device_params(self) -> np.ndarray:
        """The float32 matrix the device takes (``mpk_base``)."""
        return np.asarray(self._transition_matrix(), np.float32)

    def __repr__(self):
        return (f"ModelPerturbationKernel(nr_of_models={self.nr_of_models}, "
                f"probability_to_stay={self.probability_to_stay})")
