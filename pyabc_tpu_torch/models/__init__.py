"""Built-in models: ``models.gaussian``, ``models.lotka_volterra``,
``models.sir``, ``models.model_selection`` and ``models.gillespie``
(import them as submodules;
the package itself only exposes the integrator, which the plain versions
of the ODE kernels share)."""
from .ode import rk4_at_times, rk4_dt

__all__ = ["rk4_at_times", "rk4_dt"]
