"""Cross-validated bandwidth selection over the MVN scaling
(``pyabc_tpu/transition/grid_search.py`` counterpart, its fused path).

``GridSearchCV(MultivariateNormalTransition(), {"scaling": [0.5, 1, 2]},
cv=5)`` fits, at each generation step, one scaling-1 MVN per fold on the
other folds' weights, scores every held-out row under every candidate
scaling (a candidate's log-density is the fold fit's with ``maha / s^2``
and ``logdet + 2 dim log s``), takes the scaling of the largest summed
score and scales the full-data fit by it (K17, ``kernels/grid_search.py``).
Proposals and densities are then the MVN transition's (K2, K3): the fitted
params are K8's dict.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.grid_search import grid_search_cv
from .multivariatenormal import MultivariateNormalTransition


def fold_ids(n_rows: int, cv: int, n_cap: int) -> np.ndarray:
    """The fixed-seed fold-assignment rule of the JAX package: ``arange(
    n_rows) % min(cv, n_rows)`` shuffled by ``default_rng(0)``; rows beyond
    ``n_rows`` get -1 (no fold: in every train set with weight 0, never a
    test row)."""
    n_folds = min(int(cv), int(n_rows))
    out = np.full(int(n_cap), -1, np.int32)
    head = np.arange(int(n_rows)) % n_folds
    np.random.default_rng(0).shuffle(head)
    out[: int(n_rows)] = head
    return out


class GridSearchCV:
    """Pick the MVN scaling by K-fold held-out weighted log-likelihood.

    The port runs the fused path only: ``estimator`` is a
    ``MultivariateNormalTransition`` and ``param_grid`` is keyed by
    ``scaling`` alone (``ABCSMC`` refuses the rest, as the JAX package's
    fused gate sends them to its host loop)."""

    def __init__(self, estimator, param_grid: dict, cv: int = 5):
        self.estimator = estimator
        self.param_grid = {k: list(v) for k, v in param_grid.items()}
        self.cv = int(cv)

    @property
    def scalings(self) -> tuple:
        return tuple(float(s) for s in self.param_grid.get("scaling", ()))

    def fit_statics(self) -> dict:
        """The refit's per-model statics (the JAX package's
        ``_transition_fit_statics`` for a GridSearchCV; the folds come from
        the run, ``ABCSMC._fold_table``)."""
        return {"scalings": self.scalings,
                "bandwidth_selector": self.estimator.bandwidth_selector}

    zero_params = staticmethod(MultivariateNormalTransition.zero_params)
    device_logpdf = staticmethod(MultivariateNormalTransition.device_logpdf)

    @staticmethod
    def device_fit(thetas: torch.Tensor, weights: torch.Tensor, *, dim: int,
                   scalings: tuple, cv: int, bandwidth_selector,
                   n: int | None = None,
                   folds: torch.Tensor | None = None) -> dict:
        """K17 on one model: the JAX package's signature (``folds`` None:
        the fold ids of ``n`` rows, else a per-generation ``(n_cap,)``
        int32 row with ``cv`` folds) -> K8's params dict at the winning
        scaling."""
        n_cap = thetas.shape[0]
        if folds is None:
            n_rows = n_cap if n is None else min(int(n), n_cap)
            folds = torch.as_tensor(fold_ids(n_rows, cv, n_cap),
                                    device=thetas.device)
            n_folds = min(int(cv), n_rows)
        else:
            n_folds = int(cv)
        params, _scores, _best = grid_search_cv(
            thetas, weights, folds, n_folds=n_folds, dim=dim,
            scalings=scalings, bandwidth_selector=bandwidth_selector)
        return params

    def __repr__(self):
        return f"GridSearchCV({self.estimator!r}, {self.param_grid})"
