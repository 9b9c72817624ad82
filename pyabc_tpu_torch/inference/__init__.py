from .context import DeviceContext
from .smc import ABCSMC, DegenerateRunError

__all__ = ["ABCSMC", "DegenerateRunError", "DeviceContext"]
