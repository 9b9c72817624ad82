"""Built-in models: ``models.gaussian`` and ``models.lotka_volterra`` (import
them as submodules; the package itself only exposes the integrator, which
the LV kernel's plain version shares)."""
from .ode import rk4_at_times, rk4_dt

__all__ = ["rk4_at_times", "rk4_dt"]
