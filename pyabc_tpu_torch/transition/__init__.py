from .model_perturbation import ModelPerturbationKernel
from .multivariatenormal import MultivariateNormalTransition
from .util import (device_chol_guarded, scott_rule_of_thumb,
                   silverman_rule_of_thumb)

__all__ = ["ModelPerturbationKernel", "MultivariateNormalTransition",
           "device_chol_guarded", "scott_rule_of_thumb",
           "silverman_rule_of_thumb"]
