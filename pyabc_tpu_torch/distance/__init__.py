from . import scale
from .aggregate import AdaptiveAggregatedDistance, AggregatedDistance
from .kernel import (SCALE_LIN, SCALE_LOG, BinomialKernel,
                     IndependentLaplaceKernel, IndependentNormalKernel,
                     NegativeBinomialKernel, NormalKernel, PoissonKernel,
                     StochasticKernel)
from .pnorm import AdaptivePNormDistance, PNormDistance

__all__ = ["AdaptiveAggregatedDistance", "AdaptivePNormDistance",
           "AggregatedDistance", "BinomialKernel",
           "IndependentLaplaceKernel", "IndependentNormalKernel",
           "NegativeBinomialKernel", "NormalKernel", "PNormDistance",
           "PoissonKernel", "SCALE_LIN", "SCALE_LOG", "StochasticKernel",
           "scale"]
