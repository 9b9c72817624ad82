from . import scale
from .pnorm import AdaptivePNormDistance, PNormDistance

__all__ = ["AdaptivePNormDistance", "PNormDistance", "scale"]
