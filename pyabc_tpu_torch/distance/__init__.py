from . import scale
from .kernel import (SCALE_LIN, SCALE_LOG, BinomialKernel,
                     IndependentLaplaceKernel, IndependentNormalKernel,
                     NegativeBinomialKernel, NormalKernel, PoissonKernel,
                     StochasticKernel)
from .pnorm import AdaptivePNormDistance, PNormDistance

__all__ = ["AdaptivePNormDistance", "BinomialKernel",
           "IndependentLaplaceKernel", "IndependentNormalKernel",
           "NegativeBinomialKernel", "NormalKernel", "PNormDistance",
           "PoissonKernel", "SCALE_LIN", "SCALE_LOG", "StochasticKernel",
           "scale"]
