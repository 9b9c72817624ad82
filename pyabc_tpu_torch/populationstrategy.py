"""Population size strategies (``pyabc_tpu/populationstrategy.py``
counterpart): the constant size, a list of sizes and the adaptive size.

``AdaptivePopulationSize.update`` is the host bisection of the JAX package
over transitions with ``NR_BOOTSTRAP`` and a host ``mean_cv(n)``, the JAX
package's host loop (ROADMAP item 16); no transition of the port has one,
so it raises for them. On a run, the decision is taken on the device after
each refit (K16, ``kernels/bootstrap_cv.py``) and mirrored into
``nr_particles`` when the chunk is persisted.
"""
from __future__ import annotations

import logging

import numpy as np

from .utils import not_ported

logger = logging.getLogger("pyabc_tpu_torch.PopulationSize")


class PopulationStrategy:
    """Decides the number of particles per generation."""

    def __init__(self, nr_calibration_particles: int | None = None):
        self.nr_calibration_particles = nr_calibration_particles

    def update(self, transitions, model_weights, t: int | None = None) -> None:
        """Adapt using the fitted transitions of generation t."""

    def __call__(self, t: int | None = None) -> int:
        raise NotImplementedError

    def get_config(self) -> dict:
        return {"name": type(self).__name__}


class ConstantPopulationSize(PopulationStrategy):
    """Same n every generation."""

    def __init__(self, nr_particles: int,
                 nr_calibration_particles: int | None = None):
        super().__init__(nr_calibration_particles)
        self.nr_particles = int(nr_particles)

    def __call__(self, t: int | None = None) -> int:
        return self.nr_particles

    def get_config(self) -> dict:
        return {"name": type(self).__name__,
                "nr_particles": self.nr_particles}


class ListPopulationSize(PopulationStrategy):
    """Pre-specified n per generation."""

    def __init__(self, values, nr_calibration_particles: int | None = None):
        super().__init__(nr_calibration_particles)
        self.values = [int(v) for v in values]

    def __call__(self, t: int | None = None) -> int:
        return self.values[t]


def calc_cv(t_nr_particles: int, model_weights: np.ndarray,
            nr_bootstrap: int, transitions) -> float:
    """Mean bootstrap CV of the KDE density estimate at size
    ``t_nr_particles``, weighted over models."""
    cvs = []
    for trans in transitions:
        old = trans.NR_BOOTSTRAP
        trans.NR_BOOTSTRAP = nr_bootstrap
        try:
            cvs.append(trans.mean_cv(t_nr_particles))
        finally:
            trans.NR_BOOTSTRAP = old
    mw = np.asarray(model_weights, np.float64)
    mw = mw / mw.sum()
    return float(np.sum(mw[: len(cvs)] * np.asarray(cvs)))


class AdaptivePopulationSize(PopulationStrategy):
    """Choose the next n so that the bootstrap CV of the KDE stays at
    ``mean_cv``: a bisection over n using bootstrap replicates of the
    fitted transitions. ``nr_samples_per_parameter`` is accepted and not
    used, as in the JAX package."""

    def __init__(self, start_nr_particles: int, mean_cv: float = 0.05,
                 max_population_size: int = np.inf,
                 min_population_size: int = 10,
                 nr_samples_per_parameter: int = 1,
                 n_bootstrap: int = 10,
                 nr_calibration_particles: int | None = None):
        super().__init__(nr_calibration_particles)
        self.start_nr_particles = int(start_nr_particles)
        self.mean_cv = float(mean_cv)
        self.max_population_size = max_population_size
        self.min_population_size = int(min_population_size)
        self.n_bootstrap = int(n_bootstrap)
        self.nr_particles = int(start_nr_particles)

    def __call__(self, t: int | None = None) -> int:
        return self.nr_particles

    def update(self, transitions, model_weights, t: int | None = None) -> None:
        for trans in transitions:
            if not hasattr(trans, "mean_cv"):
                raise not_ported(
                    f"AdaptivePopulationSize.update over a "
                    f"{type(trans).__name__} without a host mean_cv (a run "
                    f"picks n on the device with K16)", "16")
        reference_nr = self.nr_particles
        lo = self.min_population_size
        hi = (int(self.max_population_size)
              if np.isfinite(self.max_population_size)
              else max(10 * reference_nr, 1000))

        def cv_at(n):
            return calc_cv(n, model_weights, self.n_bootstrap, transitions)

        try:
            if cv_at(hi) > self.mean_cv:
                self.nr_particles = hi
            else:
                while lo < hi:
                    mid = (lo + hi) // 2
                    if cv_at(mid) <= self.mean_cv:
                        hi = mid
                    else:
                        lo = mid + 1
                self.nr_particles = int(np.clip(
                    hi, self.min_population_size,
                    self.max_population_size
                    if np.isfinite(self.max_population_size) else hi))
        except Exception as e:  # transitions may be degenerate early on
            logger.warning("AdaptivePopulationSize update failed: %s", e)
        logger.info("Adapted population size from %d to %d", reference_nr,
                    self.nr_particles)

    def get_config(self) -> dict:
        return {"name": type(self).__name__,
                "start_nr_particles": self.start_nr_particles,
                "mean_cv": self.mean_cv}
