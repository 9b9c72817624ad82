"""Transition utilities (``pyabc_tpu/transition/util.py`` counterpart):
bandwidth rules, the plain device Cholesky with its jitter-escalation
ladder (single matrix beside K8 in ``kernels/mvn_fit.py``, batched beside
K13 in ``kernels/local_factor.py``) and the refit cadence's drift
statistic (beside K15 in ``kernels/proposal_drift.py``)."""
from __future__ import annotations

from ..kernels.local_factor import device_chol_guarded_batched  # noqa: F401
from ..kernels.mvn_fit import (CHOL_JITTER_LADDER,  # noqa: F401
                               device_chol_guarded)
from ..kernels.proposal_drift import device_proposal_drift  # noqa: F401


def scott_rule_of_thumb(n_samples, dimension: int):
    """Scott bandwidth factor n^(-1/(d+4)) (floats or tensors)."""
    return n_samples ** (-1.0 / (dimension + 4))


def silverman_rule_of_thumb(n_samples, dimension: int):
    """Silverman factor (4/(d+2))^(1/(d+4)) n^(-1/(d+4))."""
    return (4 / (dimension + 2)) ** (1 / (dimension + 4)) * n_samples ** (
        -1 / (dimension + 4))
