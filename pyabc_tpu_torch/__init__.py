"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu's fused
single-device ABC-SMC path (one model or model selection over several,
with priors of every family of the JAX package;
the MVN transition, its cross-validated scaling (GridSearchCV) or the
local k-NN transition; a constant, listed
or adaptive population size; p-norm, aggregated or noise-model
distances, the p-norms also through linear learned summary statistics),
for one NVIDIA H100.

Entry points run on the CUDA card unless ``device="cpu"`` is passed; the
hand-written kernels (``csrc/``) are built at first launch. Generations
run as fused chunks on the card, or on the per-generation host loop
(``fused_generations=1``, ``BatchedSampler(fused=False)``) with the
adaptation between generations on the host.
"""
from .acceptor import (ScaledPDFNorm, StochasticAcceptor, UniformAcceptor,
                       pdf_norm_from_kernel, pdf_norm_max_found)
from .core import (RV, Distribution, LowerBoundDecorator, ParameterSpace,
                   Population, RVBase, RVDecorator, ScipyRV)
from .distance import (SCALE_LIN, SCALE_LOG, AdaptiveAggregatedDistance,
                       AdaptivePNormDistance, AggregatedDistance,
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
from .predictor import (GPPredictor, LassoPredictor, LinearPredictor,
                        MLPPredictor, ModelSelectionPredictor, Predictor)
from .populationstrategy import (AdaptivePopulationSize,
                                 ConstantPopulationSize, ListPopulationSize,
                                 PopulationStrategy)
from .sampler import BatchedSampler
from .storage import History
from .sumstat import IdentitySumstat, PredictorSumstat, Sumstat
from .transition import (GridSearchCV, LocalTransition,
                         ModelPerturbationKernel,
                         MultivariateNormalTransition, scott_rule_of_thumb,
                         silverman_rule_of_thumb)

__all__ = [
    "ABCSMC", "AcceptanceRateScheme", "AdaptiveAggregatedDistance",
    "AdaptivePNormDistance", "AdaptivePopulationSize", "AggregatedDistance",
    "BatchedSampler",
    "BinomialKernel", "ConstantEpsilon", "ConstantPopulationSize",
    "DalyScheme", "DegenerateRunError", "Distribution", "Epsilon",
    "EssScheme", "ExpDecayFixedIterScheme", "ExpDecayFixedRatioScheme",
    "FrielPettittScheme", "GPPredictor", "GridSearchCV", "History", "IdentitySumstat",
    "IndependentLaplaceKernel", "LassoPredictor", "LinearPredictor",
    "IndependentNormalKernel", "ListEpsilon", "ListPopulationSize",
    "ListTemperature",
    "LocalTransition", "LowerBoundDecorator", "MLPPredictor",
    "MedianEpsilon", "ModelPerturbationKernel", "ModelSelectionPredictor",
    "MultivariateNormalTransition", "NegativeBinomialKernel",
    "NormalKernel", "PNormDistance", "ParameterSpace", "PoissonKernel",
    "PolynomialDecayFixedIterScheme", "Population", "PopulationStrategy",
    "Predictor", "PredictorSumstat",
    "QuantileEpsilon", "RV", "RVBase", "RVDecorator",
    "SCALE_LIN", "SCALE_LOG", "ScaledPDFNorm", "ScipyRV",
    "StochasticAcceptor",
    "StochasticKernel", "Sumstat", "Temperature", "TemperatureScheme",
    "TorchModel",
    "UniformAcceptor", "pdf_norm_from_kernel", "pdf_norm_max_found",
    "scott_rule_of_thumb", "silverman_rule_of_thumb",
]
