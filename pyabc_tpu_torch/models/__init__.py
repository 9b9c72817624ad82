"""Built-in models: ``models.gaussian``, ``models.lotka_volterra`` and
``models.sir`` (import them as submodules; the package itself only exposes
the integrator, which the LV and SIR kernels' plain versions share)."""
from .ode import rk4_at_times, rk4_dt

__all__ = ["rk4_at_times", "rk4_dt"]
