"""Regression predictors for learned summary statistics
(``pyabc_tpu/predictor/predictor.py`` counterpart).

``LinearPredictor`` is the weighted ridge regression behind
Fearnhead-Prangle statistics: the host fit (float64 numpy, the JAX
package's ``fit`` line for line) seeds the transform after generation 0,
and from then on K23 refits it on the card at each chunk's boundary
(``kernels/ridge_fit.py``); ``device_params(device)`` hands the fitted
transform to the kernels as float32 tensors. The other predictors of the
JAX package can be constructed, and ``ABCSMC`` refuses them with the JAX
package's reason: the MLP's in-kernel Adam fit and the host-refit mode
(Lasso, GP, model selection) are not ported yet (ROADMAP queue A, item
14).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.fit import SD_FLOOR, linear_predict
from ..utils import not_ported


def _standardize_fit(x: np.ndarray):
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd = np.where(sd > SD_FLOOR, sd, 1.0)
    return mu, sd


class Predictor:
    """y ~ f(x) regression: a host fit and the transform's device
    parameters."""

    @property
    def fitted(self) -> bool:
        return False

    def fit(self, x: np.ndarray, y: np.ndarray,
            w: np.ndarray | None = None) -> None:
        raise not_ported(f"the host fit of {type(self).__name__}", "14")

    def predict(self, x: np.ndarray) -> np.ndarray:
        raise not_ported(f"{type(self).__name__}.predict", "14")

    def __repr__(self):
        return f"{type(self).__name__}()"


class LinearPredictor(Predictor):
    """Weighted ridge regression, W = (X'ΛX + αI)^-1 X'Λ (y - ym) on
    standardized inputs (``normalize``: the host fit only; K23's refit on
    the card always standardizes, as the JAX package's kernel does)."""

    def __init__(self, alpha: float = 1e-6, normalize: bool = True):
        self.alpha = float(alpha)
        self.normalize = normalize
        self._W = None  # (S, d)
        self._b = None  # (d,)
        self._mu = None
        self._sd = None

    @property
    def fitted(self) -> bool:
        return self._W is not None

    def fit(self, x, y, w=None):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y[:, None]
        n, S = x.shape
        if self.normalize:
            self._mu, self._sd = _standardize_fit(x)
        else:
            self._mu, self._sd = np.zeros(S), np.ones(S)
        xs = (x - self._mu) / self._sd
        if w is None:
            w = np.ones(n)
        w = np.asarray(w, np.float64) * n / np.sum(w)
        xw = xs * w[:, None]
        A = xs.T @ xw + self.alpha * np.eye(S)
        ym = (w @ y) / n
        B = xs.T @ (w[:, None] * (y - ym))
        self._W = np.linalg.solve(A, B)
        self._b = ym

    def predict(self, x):
        x = np.asarray(x, np.float64)
        single = x.ndim == 1
        xs = (np.atleast_2d(x) - self._mu) / self._sd
        out = xs @ self._W + self._b
        return out[0] if single else out

    def device_params(self, device=None) -> dict:
        """The fitted transform as float32 tensors ``{"W", "b", "mu",
        "sd"}`` (contiguous)."""
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=device).contiguous()
                for k, v in (("W", self._W), ("b", self._b),
                             ("mu", self._mu), ("sd", self._sd))}

    @staticmethod
    def device_predict(x: torch.Tensor, params: dict) -> torch.Tensor:
        """Plain transform of rows: ((x - mu) / sd) @ W + b."""
        return linear_predict(x, params)

    def __repr__(self):
        return f"LinearPredictor(alpha={self.alpha})"


class LassoPredictor(LinearPredictor):
    """L1-regularized linear regression (the JAX package fits it by ISTA on
    the host, in its host-refit mode)."""

    def __init__(self, alpha: float = 0.01, n_iter: int = 500,
                 normalize: bool = True):
        super().__init__(alpha=alpha, normalize=normalize)
        self.n_iter = int(n_iter)

    def fit(self, x, y, w=None):
        raise not_ported("the host fit of LassoPredictor", "14")


class MLPPredictor(Predictor):
    """Small tanh MLP trained with Adam (the JAX package's in-kernel MLP
    plan)."""

    def __init__(self, hidden: tuple = (64, 64), n_steps: int = 400,
                 lr: float = 1e-3, seed: int = 0):
        self.hidden = tuple(hidden)
        self.n_steps = int(n_steps)
        self.lr = float(lr)
        self.seed = int(seed)


class GPPredictor(Predictor):
    """RBF kernel-ridge regression (the JAX package's host-refit mode)."""

    def __init__(self, length_scale: float | None = None,
                 alpha: float = 1e-4, cap: int = 512, seed: int = 0):
        self.length_scale = length_scale
        self.alpha = float(alpha)
        self.cap = int(cap)
        self.seed = int(seed)


class ModelSelectionPredictor(Predictor):
    """Picks the best of several predictors by validation MSE (the JAX
    package's host-refit mode)."""

    def __init__(self, predictors: list, split: float = 0.2, seed: int = 0):
        self.predictors = list(predictors)
        self.split = float(split)
        self.seed = int(seed)
