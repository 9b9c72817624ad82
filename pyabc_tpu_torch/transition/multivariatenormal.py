"""Global Gaussian-KDE perturbation kernel
(``pyabc_tpu/transition/multivariatenormal.py`` counterpart).

Params are a dict of device tensors: ``thetas (n, d)``, ``weights (n,)``,
``chol``/``prec (d, d)``, ``center (d,)``, ``thetas_c (n, d)``,
``quad (n,)``, ``logdet ()``, the ancestor ``cdf (n,)`` and the true
``dim`` (a Python float). A run over several models stacks one such set
per model (a leading model axis, ``dims (K,)`` float32 for ``dim``). ``device_fit`` is the K8 kernel, ``device_logpdf``
the K3 kernel; drawing from the fit is part of the K2 proposal kernel
(``kernels/propose.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.mvn_fit import mvn_fit
from ..kernels.mvn_logpdf import mvn_mixture_logpdf
from ..kernels.philox import PhiloxStream
from ..kernels.propose import propose, unbounded_prior
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

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "scaling": self.scaling,
                "bandwidth_selector": self.bandwidth_selector.__name__}

    def __repr__(self):
        return (f"MultivariateNormalTransition(scaling={self.scaling}, "
                f"bandwidth_selector={self.bandwidth_selector.__name__})")
