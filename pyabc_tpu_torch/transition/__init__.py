from .grid_search import GridSearchCV, fold_ids
from .local_transition import LocalTransition
from .model_perturbation import ModelPerturbationKernel
from .multivariatenormal import MultivariateNormalTransition
from .util import (device_bootstrap_indices, device_chol_guarded,
                   device_chol_guarded_batched, device_mean_cv,
                   device_proposal_drift, device_required_nr,
                   scott_rule_of_thumb, silverman_rule_of_thumb)

__all__ = ["GridSearchCV", "LocalTransition", "ModelPerturbationKernel",
           "MultivariateNormalTransition", "device_bootstrap_indices",
           "device_chol_guarded", "device_chol_guarded_batched",
           "device_mean_cv", "device_proposal_drift", "device_required_nr",
           "fold_ids",
           "scott_rule_of_thumb", "silverman_rule_of_thumb"]
