"""Population size strategies (``pyabc_tpu/populationstrategy.py``
counterpart): only the constant size is ported."""
from __future__ import annotations


class ConstantPopulationSize:
    """Same n every generation."""

    def __init__(self, nr_particles: int,
                 nr_calibration_particles: int | None = None):
        self.nr_particles = int(nr_particles)
        self.nr_calibration_particles = nr_calibration_particles

    def __call__(self, t: int | None = None) -> int:
        return self.nr_particles

    def get_config(self) -> dict:
        return {"name": type(self).__name__,
                "nr_particles": self.nr_particles}
