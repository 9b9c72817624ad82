"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu's fused
single-device ABC-SMC path (one model or model selection over several;
the MVN or, for one model, the local k-NN transition; a constant, listed
or adaptive population size), for one NVIDIA H100.

Entry points run on the CUDA card unless ``device="cpu"`` is passed; the
hand-written kernels (``csrc/``) are built at first launch.
"""
from .acceptor import (ScaledPDFNorm, StochasticAcceptor, UniformAcceptor,
                       pdf_norm_from_kernel, pdf_norm_max_found)
from .core import RV, Distribution, ParameterSpace, Population
from .distance import (SCALE_LIN, SCALE_LOG, AdaptivePNormDistance,
                       BinomialKernel, IndependentLaplaceKernel,
                       IndependentNormalKernel, NegativeBinomialKernel,
                       NormalKernel, PNormDistance, PoissonKernel,
                       StochasticKernel)
from .epsilon import (AcceptanceRateScheme, ConstantEpsilon, DalyScheme,
                      Epsilon, EssScheme, ExpDecayFixedIterScheme,
                      ExpDecayFixedRatioScheme, FrielPettittScheme,
                      ListEpsilon, ListTemperature, MedianEpsilon,
                      PolynomialDecayFixedIterScheme, QuantileEpsilon,
                      Temperature, TemperatureScheme)
from .inference import ABCSMC, DegenerateRunError
from .model import TorchModel
from .populationstrategy import (AdaptivePopulationSize,
                                 ConstantPopulationSize, ListPopulationSize,
                                 PopulationStrategy)
from .storage import History
from .transition import (LocalTransition, ModelPerturbationKernel,
                         MultivariateNormalTransition, scott_rule_of_thumb,
                         silverman_rule_of_thumb)

__all__ = [
    "ABCSMC", "AcceptanceRateScheme", "AdaptivePNormDistance",
    "AdaptivePopulationSize",
    "BinomialKernel", "ConstantEpsilon", "ConstantPopulationSize",
    "DalyScheme", "DegenerateRunError", "Distribution", "Epsilon",
    "EssScheme", "ExpDecayFixedIterScheme", "ExpDecayFixedRatioScheme",
    "FrielPettittScheme", "History", "IndependentLaplaceKernel",
    "IndependentNormalKernel", "ListEpsilon", "ListPopulationSize",
    "ListTemperature",
    "LocalTransition", "MedianEpsilon", "ModelPerturbationKernel",
    "MultivariateNormalTransition", "NegativeBinomialKernel",
    "NormalKernel", "PNormDistance", "ParameterSpace", "PoissonKernel",
    "PolynomialDecayFixedIterScheme", "Population", "PopulationStrategy",
    "QuantileEpsilon", "RV",
    "SCALE_LIN", "SCALE_LOG", "ScaledPDFNorm", "StochasticAcceptor",
    "StochasticKernel", "Temperature", "TemperatureScheme", "TorchModel",
    "UniformAcceptor", "pdf_norm_from_kernel", "pdf_norm_max_found",
    "scott_rule_of_thumb", "silverman_rule_of_thumb",
]
