"""Stochastic kernels: noise-model "distances" for noisy ABC
(``pyabc_tpu/distance/kernel.py`` counterpart).

A kernel returns the (log-)density of the observation x_0 under a noise
model centred at the simulation x; ``StochasticAcceptor`` accepts with
probability proportional to density^(1/T). Every device-compatible noise
model of the JAX package is ported: the independent normal (K21a), the
full-covariance normal, independent Laplace, binomial, Poisson and
negative binomial (K21c), all through the one accept kernel
(``kernels/kernel_accept.py``), which computes the log-density, the accept
test and the log weight of a round in one launch. Each kernel's
``family`` names its code there, and ``device_params`` gives its flat
float32 parameter vector.

``device_bound_fn`` is the monotone upper bound on the log-density over
sum-stat prefixes that K18's noisy mode retires candidates on, exactly
where the JAX package has one (independent normal and Laplace from their
``pdf_max``, log-scale binomial and Poisson from 0), else None. A callable
variance or scale and a ``keys`` subset raise ``not_ported``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.kernel_accept import noise_bound_fold, upper_exceeds
from ..utils import not_ported

SCALE_LIN = "SCALE_LIN"
SCALE_LOG = "SCALE_LOG"

_LOG_2PI = math.log(2.0 * math.pi)


class StochasticKernel:
    """Base stochastic kernel. ``ret_scale`` says whether ``__call__``
    returns the density (SCALE_LIN) or its log (SCALE_LOG); ``pdf_max`` is
    the (log-)maximum of the density over x, computed at ``initialize``
    where the subclass can.

    On the fused path the JAX package's ``device_fn(spec)`` reads the run's
    whole flat row, not the ``keys`` subset its host ``__call__`` selects,
    so a ``keys`` subset raises here (ROADMAP queue C records it)."""

    adaptive = False
    #: the noise family of ``kernels/kernel_accept.py``
    family = ""

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

    def _column_params(self) -> np.ndarray:
        """The (S,) float64 per-column parameter of an elementwise
        family."""
        raise NotImplementedError

    def device_params(self, device) -> torch.Tensor:
        """The flat float32 parameter vector the accept kernel reads."""
        return torch.as_tensor(self._column_params().astype(np.float32),
                               device=device).contiguous()

    #: the run's device parameters, in the slot of a p-norm's weights
    def initial_weights(self, device) -> torch.Tensor:
        return self.device_params(device)

    def device_bound_fn(self, spec=None) -> dict | None:
        """The upper bound of K18's noisy mode, or None (no sound bound)."""
        return None

    def _upper_bound(self, init_value: float) -> dict:
        """``device_bound_fn``'s dict: ``init(B)``, ``step(acc, vals, idx,
        x0, params)`` (``vals`` a segment's ``(B, k)`` block at flat
        columns ``idx``, ``params`` the device parameters) and ``exceeds(acc,
        threshold)`` (``_upper_exceeds``), with ``upper`` True, the family
        and the float32 start value K18 takes."""
        family = self.family
        init_value = float(np.float32(init_value))

        def init(B: int, device=None) -> torch.Tensor:
            return torch.full((B,), init_value, dtype=torch.float32,
                              device=device)

        def step(acc, vals, idx, x0, params):
            idx = torch.as_tensor(idx, dtype=torch.int64, device=acc.device)
            return noise_bound_fold(family, acc, vals, x0[idx], params[idx])

        def exceeds(acc, threshold):
            return upper_exceeds(acc, torch.as_tensor(
                threshold, dtype=torch.float32, device=acc.device))

        return {"init": init, "step": step, "exceeds": exceeds,
                "upper": True, "family": family, "init_value": init_value}

    def _total(self, logp) -> float:
        total = float(np.sum(logp))
        return math.exp(total) if self.ret_scale == SCALE_LIN else total

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "ret_scale": self.ret_scale}


class NormalKernel(StochasticKernel):
    """Multivariate normal noise with a full covariance ``cov`` (None: the
    identity). The precision and the log-determinant are computed on the
    host in float64 and handed to the card in float32."""

    family = "normal"

    def __init__(self, cov=None, ret_scale: str = SCALE_LOG, keys=None):
        super().__init__(ret_scale, keys, None)
        self._cov_arg = cov
        self._prec = None
        self._logdet = None
        self._dim = None

    def initialize(self, spec) -> None:
        super().initialize(spec)
        dim = spec.total_size
        cov = self._cov_arg if self._cov_arg is not None else np.eye(dim)
        cov = np.atleast_2d(np.asarray(cov, np.float64))
        if cov.shape != (dim, dim):
            raise ValueError(f"kernel covariance of shape {cov.shape} for "
                             f"{dim} summary statistics")
        self._dim = dim
        self._prec = np.linalg.inv(cov)
        sign, logdet = np.linalg.slogdet(cov)
        if sign <= 0:
            raise ValueError("kernel covariance must be positive definite")
        self._logdet = logdet
        self.pdf_max = -0.5 * (dim * _LOG_2PI + logdet)
        if self.ret_scale == SCALE_LIN:
            self.pdf_max = math.exp(self.pdf_max)

    def __call__(self, x, x_0, t=None, par=None) -> float:
        diff = self._flat(x) - self._flat(x_0)
        logp = -0.5 * (self._dim * _LOG_2PI + self._logdet
                       + diff @ self._prec @ diff)
        return (float(np.exp(logp)) if self.ret_scale == SCALE_LIN
                else float(logp))

    def device_params(self, device) -> torch.Tensor:
        """The (S, S) precision row-major, then the log-determinant and
        ``S log 2 pi``, each rounded to float32: ``(S * S + 2,)``."""
        flat = np.concatenate([
            np.asarray(self._prec, np.float32).ravel(),
            np.array([self._logdet, self._dim * _LOG_2PI], np.float32)])
        return torch.as_tensor(flat, device=device).contiguous()

    def get_config(self) -> dict:
        return {**super().get_config(),
                "cov": (None if self._cov_arg is None
                        else np.asarray(self._cov_arg, np.float64).tolist())}


class IndependentNormalKernel(StochasticKernel):
    """Independent normal noise per statistic. ``var`` is a scalar or a
    vector (None: all ones); a callable ``var(par)`` (an inferred noise
    parameter) is not ported: the JAX package's fused path refuses it too
    (``is_device_compatible``), so it belongs to the host loop."""

    family = "independent_normal"

    def __init__(self, var=None, keys=None):
        super().__init__(SCALE_LOG, keys, None)
        if callable(var):
            raise not_ported("IndependentNormalKernel with a callable var "
                             "(the host loop)", "11")
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

    def _column_params(self) -> np.ndarray:
        return self.var_vec

    def device_bound_fn(self, spec=None) -> dict | None:
        """Start at ``pdf_max`` (the sum of the per-entry maxima) and
        subtract each emitted entry's deficit ``0.5 diff^2 / var``."""
        if self.pdf_max is None:
            return None
        return self._upper_bound(self.pdf_max)

    def get_config(self) -> dict:
        return {**super().get_config(),
                "var": (None if self.var is None
                        else np.asarray(self.var, np.float64).tolist())}


class IndependentLaplaceKernel(StochasticKernel):
    """Independent Laplace noise per statistic with scale ``scale`` (a
    scalar or a vector, None: all ones); a callable scale is not
    ported."""

    family = "laplace"

    def __init__(self, scale=None, keys=None):
        super().__init__(SCALE_LOG, keys, None)
        if callable(scale):
            raise not_ported("IndependentLaplaceKernel with a callable "
                             "scale (the host loop)", "11")
        self.scale = scale
        self.scale_vec: np.ndarray | None = None

    def initialize(self, spec) -> None:
        super().initialize(spec)
        b = 1.0 if self.scale is None else self.scale
        self.scale_vec = np.array(np.broadcast_to(
            np.asarray(b, np.float64), (spec.total_size,)))
        self.pdf_max = float(-np.sum(np.log(2.0 * self.scale_vec)))

    def __call__(self, x, x_0, t=None, par=None) -> float:
        diff = self._flat(x) - self._flat(x_0)
        b = np.broadcast_to(self.scale_vec, diff.shape)
        return float(-np.sum(np.log(2.0 * b) + np.abs(diff) / b))

    def _column_params(self) -> np.ndarray:
        return self.scale_vec

    def device_bound_fn(self, spec=None) -> dict | None:
        """Start at ``pdf_max`` (per-entry maxima ``-log 2b``) and subtract
        each emitted entry's deficit ``|diff| / b``."""
        if self.pdf_max is None:
            return None
        return self._upper_bound(self.pdf_max)

    def get_config(self) -> dict:
        return {**super().get_config(),
                "scale": (None if self.scale is None
                          else np.asarray(self.scale, np.float64).tolist())}


class BinomialKernel(StochasticKernel):
    """Binomial observation noise: x_0 ~ Binom(n = round(sim), p)."""

    family = "binomial"

    def __init__(self, p: float, ret_scale: str = SCALE_LOG, keys=None):
        if not 0 < p <= 1:
            raise ValueError("p must be in (0, 1]")
        super().__init__(ret_scale, keys,
                         0.0 if ret_scale == SCALE_LOG else 1.0)
        self.p = float(p)

    def __call__(self, x, x_0, t=None, par=None) -> float:
        from scipy.stats import binom

        n = np.maximum(np.round(self._flat(x)), 0.0)
        k = np.round(self._flat(x_0))
        return self._total(binom.logpmf(k, n, self.p))

    def _column_params(self) -> np.ndarray:
        return np.full(self.spec.total_size, self.p)

    def device_bound_fn(self, spec=None) -> dict | None:
        """A pmf never exceeds 1, so the prefix sum of the actual per-entry
        log-pmfs upper-bounds the total: start at 0, add the terms. Log
        scale only (the lin density's clamp is not prefix-separable)."""
        if self.ret_scale != SCALE_LOG:
            return None
        return self._upper_bound(0.0)

    def get_config(self) -> dict:
        return {**super().get_config(), "p": self.p}


class PoissonKernel(StochasticKernel):
    """Poisson observation noise: x_0 ~ Poisson(max(sim, 1e-12))."""

    family = "poisson"

    def __init__(self, ret_scale: str = SCALE_LOG, keys=None):
        super().__init__(ret_scale, keys,
                         0.0 if ret_scale == SCALE_LOG else 1.0)

    def __call__(self, x, x_0, t=None, par=None) -> float:
        from scipy.special import gammaln

        lam = np.maximum(self._flat(x), 1e-12)
        k = np.round(self._flat(x_0))
        logp = k * np.log(lam) - lam - gammaln(k + 1.0)
        return self._total(np.where(k >= 0, logp, -np.inf))

    def _column_params(self) -> np.ndarray:
        return np.zeros(self.spec.total_size)

    def device_bound_fn(self, spec=None) -> dict | None:
        """The pmf <= 1 bound of :meth:`BinomialKernel.device_bound_fn`."""
        if self.ret_scale != SCALE_LOG:
            return None
        return self._upper_bound(0.0)


class NegativeBinomialKernel(StochasticKernel):
    """Negative-binomial observation noise with dispersion p.
    ``parameterization="size"`` (the reference's): the simulated value is
    the size n of ``nbinom.pmf(k=x_0, n=sim, p)``; ``"mean"``: it is the
    mean, n = mean p / (1 - p). No upper bound: its pmf's maximum over x
    is not known in closed form here, as in the JAX package."""

    def __init__(self, p: float, ret_scale: str = SCALE_LOG, keys=None,
                 parameterization: str = "size"):
        super().__init__(ret_scale, keys, None)
        self.p = float(p)
        if parameterization not in ("size", "mean"):
            raise ValueError(
                f"parameterization must be 'size' or 'mean', got "
                f"{parameterization!r}")
        self.parameterization = parameterization

    @property
    def family(self) -> str:
        return f"negbin_{self.parameterization}"

    def __call__(self, x, x_0, t=None, par=None) -> float:
        from scipy.special import gammaln

        n = np.maximum(self._flat(x), 1e-12)
        if self.parameterization == "mean":
            n = n * self.p / (1.0 - self.p)
        k = np.round(self._flat(x_0))
        logp = (gammaln(k + n) - gammaln(n) - gammaln(k + 1.0)
                + n * np.log(self.p) + k * np.log1p(-self.p))
        return self._total(np.where(k >= 0, logp, -np.inf))

    def _column_params(self) -> np.ndarray:
        return np.full(self.spec.total_size, self.p)

    def get_config(self) -> dict:
        return {**super().get_config(), "p": self.p,
                "parameterization": self.parameterization}
