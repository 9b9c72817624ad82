"""Stochastic kernels: noise-model "distances" for noisy ABC
(``pyabc_tpu/distance/kernel.py`` counterpart).

A kernel returns the (log-)density of the observation x_0 under a noise
model centred at the simulation x; ``StochasticAcceptor`` accepts with
probability proportional to density^(1/T). Only ``IndependentNormalKernel``
with a fixed variance is ported: its device form is the K21a kernel
(``kernels/kernel_accept.py``), which computes the log-density, the accept
test and the log weight of a round in one launch. The other noise models
(K21c) and a callable variance raise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import not_ported

SCALE_LIN = "SCALE_LIN"
SCALE_LOG = "SCALE_LOG"

_LOG_2PI = math.log(2.0 * math.pi)


class StochasticKernel:
    """Base stochastic kernel. ``ret_scale`` says whether ``__call__``
    returns the density (SCALE_LIN) or its log (SCALE_LOG); ``pdf_max`` is
    the (log-)maximum of the density over x, computed at ``initialize``
    where the subclass can."""

    adaptive = False

    def __init__(self, ret_scale: str = SCALE_LOG, keys=None,
                 pdf_max: float | None = None):
        if ret_scale not in (SCALE_LIN, SCALE_LOG):
            raise ValueError(f"ret_scale must be SCALE_LIN/SCALE_LOG: "
                             f"{ret_scale}")
        if keys is not None:
            raise not_ported("a stochastic kernel over a subset of the "
                             "summary statistics (keys)", "11")
        self.ret_scale = ret_scale
        self.pdf_max = pdf_max
        self.spec = None

    def requires_calibration(self) -> bool:
        return False

    def initialize(self, spec) -> None:
        self.spec = spec

    def _flat(self, x) -> np.ndarray:
        if hasattr(x, "keys"):
            return self.spec.flatten_host(x)
        return np.ravel(np.asarray(x, np.float64))

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "ret_scale": self.ret_scale}


class IndependentNormalKernel(StochasticKernel):
    """Independent normal noise per statistic. ``var`` is a scalar or a
    vector (None: all ones); a callable ``var(par)`` (an inferred noise
    parameter) is not ported."""

    def __init__(self, var=None, keys=None):
        super().__init__(SCALE_LOG, keys, None)
        if callable(var):
            raise not_ported("IndependentNormalKernel with a callable var "
                             "(K21c)", "11")
        self.var = var
        #: the variance of every flat statistic, set by ``initialize``
        self.var_vec: np.ndarray | None = None

    def initialize(self, spec) -> None:
        super().initialize(spec)
        var = 1.0 if self.var is None else self.var
        self.var_vec = np.array(np.broadcast_to(
            np.asarray(var, np.float64), (spec.total_size,)))
        self.pdf_max = float(-0.5 * np.sum(_LOG_2PI + np.log(self.var_vec)))

    def __call__(self, x, x_0, t=None, par=None) -> float:
        diff = self._flat(x) - self._flat(x_0)
        var = np.broadcast_to(self.var_vec, diff.shape)
        return float(-0.5 * np.sum(_LOG_2PI + np.log(var)
                                   + diff * diff / var))

    def device_params(self, device) -> torch.Tensor:
        """The (S,) float32 variance vector K21a reads."""
        return torch.as_tensor(self.var_vec.astype(np.float32),
                               device=device).contiguous()

    #: the run's device parameters, in the slot of a p-norm's weights
    initial_weights = device_params

    def get_config(self) -> dict:
        return {**super().get_config(),
                "var": (None if self.var is None
                        else np.asarray(self.var, np.float64).tolist())}


def _k21c(name: str):
    class NotPorted(StochasticKernel):
        def __init__(self, *args, **kwargs):
            raise not_ported(f"the {name} noise model (K21c)", "11")

    NotPorted.__name__ = NotPorted.__qualname__ = name
    NotPorted.__doc__ = f"``pyabc_tpu`` {name}: not ported yet (K21c)."
    return NotPorted


NormalKernel = _k21c("NormalKernel")
IndependentLaplaceKernel = _k21c("IndependentLaplaceKernel")
BinomialKernel = _k21c("BinomialKernel")
PoissonKernel = _k21c("PoissonKernel")
NegativeBinomialKernel = _k21c("NegativeBinomialKernel")
