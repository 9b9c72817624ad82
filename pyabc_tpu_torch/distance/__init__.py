from . import scale
from .kernel import (SCALE_LIN, SCALE_LOG, IndependentNormalKernel,
                     StochasticKernel)
from .pnorm import AdaptivePNormDistance, PNormDistance

__all__ = ["AdaptivePNormDistance", "IndependentNormalKernel",
           "PNormDistance", "SCALE_LIN", "SCALE_LOG", "StochasticKernel",
           "scale"]
