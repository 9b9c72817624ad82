"""Transition utilities (``pyabc_tpu/transition/util.py`` counterpart):
bandwidth rules, and the plain device Cholesky with its jitter-escalation
ladder, which lives beside the K8 kernel in ``kernels/mvn_fit.py``."""
from __future__ import annotations

from ..kernels.mvn_fit import (CHOL_JITTER_LADDER,  # noqa: F401
                               device_chol_guarded)


def scott_rule_of_thumb(n_samples, dimension: int):
    """Scott bandwidth factor n^(-1/(d+4)) (floats or tensors)."""
    return n_samples ** (-1.0 / (dimension + 4))


def silverman_rule_of_thumb(n_samples, dimension: int):
    """Silverman factor (4/(d+2))^(1/(d+4)) n^(-1/(d+4))."""
    return (4 / (dimension + 2)) ** (1 / (dimension + 4)) * n_samples ** (
        -1 / (dimension + 4))
