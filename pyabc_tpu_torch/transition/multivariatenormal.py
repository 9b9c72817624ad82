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
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.mvn_fit import mvn_fit
from ..kernels.mvn_logpdf import mvn_mixture_logpdf
from ..kernels.philox import PhiloxStream
from ..kernels.propose import propose, unbounded_prior
from . import util
from .util import scott_rule_of_thumb, silverman_rule_of_thumb


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
