"""pyabc_tpu_torch: the PyTorch / CUDA port of pyabc_tpu's fused
single-model ABC-SMC path, for one NVIDIA H100.

Entry points run on the CUDA card unless ``device="cpu"`` is passed; the
hand-written kernels (``csrc/``) are built at first launch.
"""
from .acceptor import UniformAcceptor
from .core import RV, Distribution, ParameterSpace, Population
from .distance import AdaptivePNormDistance, PNormDistance
from .epsilon import (ConstantEpsilon, Epsilon, ListEpsilon, MedianEpsilon,
                      QuantileEpsilon)
from .inference import ABCSMC, DegenerateRunError
from .model import TorchModel
from .populationstrategy import ConstantPopulationSize
from .storage import History
from .transition import (MultivariateNormalTransition, scott_rule_of_thumb,
                         silverman_rule_of_thumb)

__all__ = [
    "ABCSMC", "AdaptivePNormDistance", "ConstantEpsilon",
    "ConstantPopulationSize", "DegenerateRunError", "Distribution",
    "Epsilon", "History", "ListEpsilon", "MedianEpsilon",
    "MultivariateNormalTransition", "PNormDistance",
    "ParameterSpace", "Population", "QuantileEpsilon", "RV", "TorchModel",
    "UniformAcceptor", "scott_rule_of_thumb", "silverman_rule_of_thumb",
]
