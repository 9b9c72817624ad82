"""Global Gaussian-KDE perturbation kernel
(``pyabc_tpu/transition/multivariatenormal.py`` counterpart).

Params are a dict of device tensors: ``thetas (n, d)``, ``weights (n,)``,
``chol``/``prec (d, d)``, ``center (d,)``, ``thetas_c (n, d)``,
``quad (n,)``, ``logdet ()``, the ancestor ``cdf (n,)`` and the true
``dim`` (a Python float). A run over several models stacks one such set
per model (a leading model axis, ``dims (K,)`` float32 for ``dim``).
``device_fit`` is the K8 kernel, ``device_logpdf`` the K3 kernel; drawing
from the fit is part of the K2 proposal kernel (``kernels/propose.py``).
``device_mean_cv`` and ``device_required_nr`` are the bootstrap CV and
bisection of the adaptive population size on one fit, through K16's
entries (``kernels/bootstrap_cv.py``).

The per-generation host loop fits on the host instead: ``fit(X, w)`` in
float64 numpy (``smart_cov``, the bandwidth from the ESS, one 1e-10
jitter retry), ``pdf`` the mixture density there, and ``device_params``
the float32 params K2 and K3 take, padded to a bucket of rows.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..kernels.mvn_fit import mvn_fit
from ..kernels.mvn_logpdf import mvn_mixture_logpdf
from ..kernels.philox import PhiloxStream
from ..kernels.propose import propose, unbounded_prior
from . import util
from .util import (NotEnoughParticles, scott_rule_of_thumb,
                   silverman_rule_of_thumb, smart_cov)

_LOG_2PI = math.log(2.0 * math.pi)


class MultivariateNormalTransition:
    """Weighted Gaussian KDE transition (the default kernel)."""

    def __init__(self, scaling: float = 1.0,
                 bandwidth_selector: Callable = silverman_rule_of_thumb):
        if bandwidth_selector not in (scott_rule_of_thumb,
                                      silverman_rule_of_thumb):
            raise NotImplementedError(
                "only the scott/silverman bandwidth rules are ported "
                "(ROADMAP queue A, item 12)")
        self.scaling = float(scaling)
        self.bandwidth_selector = bandwidth_selector
        #: the host fit's rows ``(n, d)`` float64 and their normalized
        #: weights (None until ``fit``)
        self.X: np.ndarray | None = None
        self.w: np.ndarray | None = None
        self._chol = self._prec = self._logdet = None

    # ----------------------------------------------------------- host fit
    def fit(self, X, w) -> None:
        """The host fit of the per-generation loop
        (``pyabc_tpu/transition/multivariatenormal.py:43-60``): the
        weighted covariance (``smart_cov``) scaled by the bandwidth of the
        weights' ESS, its Cholesky factor (one 1e-10 jitter retry), the
        precision and the log-determinant, all float64. The rows are held
        column-major, the layout of the JAX package's DataFrame, so the BLAS
        products round as there."""
        arr = np.asfortranarray(X, dtype=np.float64)
        if len(arr) == 0:
            raise NotEnoughParticles("fitting to no samples")
        if len(arr) != len(w):
            raise ValueError("X and w must have equal length")
        w = np.asarray(w, np.float64)
        total = np.sum(w)
        if not np.isclose(total, 1.0):
            w = w / total
        self.X, self.w = arr, w
        dim = arr.shape[1]
        s = w.sum()
        ess = float(s * s / np.sum(w * w))
        cov = smart_cov(arr, w) * (
            self.scaling * self.bandwidth_selector(ess, dim)) ** 2
        try:
            chol = np.linalg.cholesky(cov)
        except np.linalg.LinAlgError:
            cov = cov + np.eye(dim) * 1e-10
            chol = np.linalg.cholesky(cov)
        self._chol = chol
        self._prec = np.linalg.inv(cov)
        self._logdet = float(np.linalg.slogdet(cov)[1])

    def pdf(self, x) -> np.ndarray | float:
        """The fitted mixture's density at ``x`` (``(d,)`` or ``(q, d)``)."""
        arr = np.asarray(x, np.float64)
        single = arr.ndim == 1
        arr = np.atleast_2d(arr)
        dim = self.X.shape[1]
        diff = arr[:, None, :] - self.X[None, :, :]
        maha = np.einsum("qnd,de,qne->qn", diff, self._prec, diff)
        log_comp = -0.5 * (dim * _LOG_2PI + self._logdet + maha)
        dens = np.exp(log_comp) @ self.w
        return float(dens[0]) if single else dens

    def device_params(self, n_cap: int | None = None,
                      d_max: int | None = None) -> dict:
        """The host fit as the float32 params K2 and K3 take
        (``multivariatenormal.py:96`` with ``util.py::pad_transition_params``
        and the ancestor cdf): numpy arrays, rows padded to ``n_cap`` with
        weight 0 and columns to ``d_max`` with zeros; ``dim`` the fit's
        dimension."""
        n, dim = self.X.shape
        n_cap = n if n_cap is None else int(n_cap)
        d_max = dim if d_max is None else int(d_max)
        th = np.asarray(self.X, np.float32)
        prec = np.asarray(self._prec, np.float32)
        center = (self.w @ self.X).astype(np.float32)
        th_c = th - center[None, :]
        w = np.asarray(self.w, np.float32)
        raw = {
            "thetas": th, "weights": w,
            "chol": np.asarray(self._chol, np.float32), "prec": prec,
            "center": center, "thetas_c": th_c,
            "quad": np.einsum("nd,de,ne->n", th_c, prec, th_c).astype(
                np.float32),
            "logdet": np.asarray(self._logdet, np.float32)}
        out = {}
        for k, v in raw.items():
            p = np.zeros({"thetas": (n_cap, d_max), "thetas_c": (n_cap, d_max),
                          "weights": (n_cap,), "quad": (n_cap,),
                          "center": (d_max,), "chol": (d_max, d_max),
                          "prec": (d_max, d_max), "logdet": ()}[k],
                         np.float32)
            p[tuple(slice(0, s) for s in v.shape)] = v
            out[k] = p
        # K2's ancestor search: zero-weight rows repeat the previous cdf
        out["cdf"] = np.maximum.accumulate(np.where(
            out["weights"] > 0, np.cumsum(out["weights"], dtype=np.float32),
            np.float32(0)))
        out["dim"] = float(dim)
        return out

    def fit_statics(self) -> dict:
        return {"scaling": self.scaling,
                "bandwidth_selector": self.bandwidth_selector}

    @staticmethod
    def zero_params(n: int, d: int, device) -> dict:
        """Placeholder params of a never-fitted transition."""
        shapes = {"thetas": (n, d), "weights": (n,), "chol": (d, d),
                  "prec": (d, d), "center": (d,), "thetas_c": (n, d),
                  "quad": (n,), "logdet": (), "cdf": (n,)}
        params = {k: torch.zeros(s, dtype=torch.float32, device=device)
                  for k, s in shapes.items()}
        return {**params, "dim": float(d)}

    @staticmethod
    def zero_params_models(K: int, n: int, d: int,
                           dims: torch.Tensor) -> dict:
        """Placeholder stacked params of K never-fitted models (``dims``
        the models' dims, a float32 tensor on the run's device)."""
        one = MultivariateNormalTransition.zero_params(n, d, dims.device)
        del one["dim"]
        return {**{k: torch.zeros((K, *v.shape), dtype=v.dtype,
                                  device=v.device)
                   for k, v in one.items()}, "dims": dims}

    @staticmethod
    def device_fit(thetas: torch.Tensor, weights: torch.Tensor, *, dim: int,
                   scaling: float, bandwidth_selector: Callable) -> dict:
        """Weighted mean/cov (smart_cov guard), bandwidth from the ESS,
        jitter-ladder Cholesky, precision, logdet, the centred cache and
        the ancestor cdf (K8)."""
        return mvn_fit(thetas, weights, dim=dim, scaling=scaling,
                       bandwidth_selector=bandwidth_selector)

    @staticmethod
    def device_rvs(params: dict, n: int, stream: PhiloxStream,
                   prior: dict | None = None) -> torch.Tensor:
        """``n`` draws (K2): weighted ancestor by inverse CDF + chol @ z,
        redrawn against zero mass under ``prior`` (``Distribution.arrays``;
        None means no bounds, so the first draw is kept)."""
        if prior is None:
            prior = unbounded_prior(params["thetas"].shape[1],
                                    params["thetas"].device)
        return propose(stream, n, prior, params)[0]

    @staticmethod
    def device_logpdf(q: torch.Tensor, params: dict) -> torch.Tensor:
        """``(B, d)`` -> ``(B,)`` mixture log-density (K3)."""
        return mvn_mixture_logpdf(q.contiguous(), params)

    @staticmethod
    def device_mean_cv(params: dict, idx: torch.Tensor, n, *, dim: int,
                       scaling: float,
                       bandwidth_selector: Callable) -> torch.Tensor:
        """Bootstrap CV of the KDE density at resample size ``n`` on the
        ancestors ``idx (n_bootstrap, n_cap)`` (``util.device_mean_cv``;
        the JAX package's static takes a key and draws them itself)."""
        return util.device_mean_cv(
            params, idx, n, dim=dim, scaling=scaling,
            bandwidth_selector=bandwidth_selector)

    @staticmethod
    def device_required_nr(params: dict, idx: torch.Tensor, *,
                           target_cv: float, min_n: int, max_n: int,
                           dim: int, scaling: float,
                           bandwidth_selector: Callable) -> int:
        """``AdaptivePopulationSize.update``'s bisection on the bootstrap CV
        of this fit, the same ancestors for every probe."""
        def cv_at(n):
            return MultivariateNormalTransition.device_mean_cv(
                params, idx, n, dim=dim, scaling=scaling,
                bandwidth_selector=bandwidth_selector)

        return util.device_required_nr(cv_at, target_cv=target_cv,
                                       min_n=min_n, max_n=max_n)

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "scaling": self.scaling,
                "bandwidth_selector": self.bandwidth_selector.__name__}

    def __repr__(self):
        return (f"MultivariateNormalTransition(scaling={self.scaling}, "
                f"bandwidth_selector={self.bandwidth_selector.__name__})")
