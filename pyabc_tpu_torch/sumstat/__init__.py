"""Summary-statistic transforms (``pyabc_tpu/sumstat/`` counterpart)."""
from .base import IdentitySumstat, PredictorSumstat, Sumstat
from .device import (device_fit_plan, host_caps_reason, mirror_fitted_params,
                     seed_params_ready, transform_kind)

__all__ = ["IdentitySumstat", "PredictorSumstat", "Sumstat",
           "device_fit_plan", "host_caps_reason", "mirror_fitted_params",
           "seed_params_ready", "transform_kind"]
