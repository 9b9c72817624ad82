from .local_transition import LocalTransition
from .model_perturbation import ModelPerturbationKernel
from .multivariatenormal import MultivariateNormalTransition
from .util import (device_chol_guarded, device_chol_guarded_batched,
                   device_proposal_drift, scott_rule_of_thumb,
                   silverman_rule_of_thumb)

__all__ = ["LocalTransition", "ModelPerturbationKernel",
           "MultivariateNormalTransition", "device_chol_guarded",
           "device_chol_guarded_batched", "device_proposal_drift",
           "scott_rule_of_thumb", "silverman_rule_of_thumb"]
