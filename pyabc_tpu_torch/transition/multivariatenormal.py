"""Global Gaussian-KDE perturbation kernel
(``pyabc_tpu/transition/multivariatenormal.py`` counterpart).

Params are a dict of device tensors: ``thetas (n, d)``, ``weights (n,)``,
``chol``/``prec (d, d)``, ``center (d,)``, ``thetas_c (n, d)``,
``quad (n,)``, ``logdet ()`` and the true ``dim`` (a Python float).
``device_fit`` (K8) and ``device_rvs`` (part of K2) are plain PyTorch;
``device_logpdf`` is the K3 kernel.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.mvn_logpdf import mvn_mixture_logpdf
from .util import (device_chol_guarded, scott_rule_of_thumb,
                   silverman_rule_of_thumb)


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
                  "quad": (n,), "logdet": ()}
        params = {k: torch.zeros(s, dtype=torch.float32, device=device)
                  for k, s in shapes.items()}
        return {**params, "dim": float(d)}

    @staticmethod
    def device_fit(thetas: torch.Tensor, weights: torch.Tensor, *, dim: int,
                   scaling: float, bandwidth_selector: Callable) -> dict:
        """Weighted mean/cov (smart_cov guard), bandwidth from the ESS,
        jitter-ladder Cholesky, precision, logdet and the centred cache."""
        d_max = thetas.shape[1]
        vmask = (torch.arange(d_max, device=thetas.device) < dim).to(
            thetas.dtype)
        w = weights / weights.sum().clamp_min(1e-38)
        mean = w @ thetas
        centered = thetas - mean
        cov = (centered * w[:, None]).T @ centered
        diag = torch.diagonal(cov)
        fill = mean.abs() * 1e-4 + 1e-8
        cov = cov + torch.diag(torch.where(diag <= 0, fill - diag,
                                           torch.zeros_like(diag)))
        ess = 1.0 / (w * w).sum().clamp_min(1e-38)
        factor = bandwidth_selector(ess, dim)
        cov = cov * (scaling * factor) ** 2
        chol, cov, _bad = device_chol_guarded(cov)
        prec, _info = torch.linalg.inv_ex(cov)
        logdet = 2.0 * (vmask * torch.log(
            torch.diagonal(chol).clamp_min(1e-38))).sum()
        outer = vmask[:, None] * vmask[None, :]
        prec = (prec * outer).contiguous()
        th = thetas * vmask[None, :]
        center = mean * vmask
        th_c = (th - center[None, :]).contiguous()
        return {
            "thetas": th.contiguous(),
            "weights": w.contiguous(),
            "chol": (chol * outer).contiguous(),
            "prec": prec,
            "center": center.contiguous(),
            "thetas_c": th_c,
            "quad": ((th_c @ prec) * th_c).sum(dim=1).contiguous(),
            "logdet": logdet,
            "dim": float(dim),
        }

    @staticmethod
    def device_rvs(params: dict, n: int,
                   generator: torch.Generator) -> torch.Tensor:
        """``n`` draws: weighted ancestor pick (inverse CDF) + chol @ z."""
        w = params["weights"]
        # zero-weight rows (empty reservoir slots) repeat the previous
        # row's cdf exactly, so the search never lands on them; cummax
        # keeps the cdf monotone whatever order the scan summed in
        cdf = torch.cummax(torch.where(w > 0, torch.cumsum(w, 0),
                                       torch.zeros_like(w)), 0).values
        total = cdf[-1]
        u = torch.rand(n, generator=generator, device=w.device) * total
        # u must stay below the total, which rand * total can round up to
        u = torch.minimum(u, torch.nextafter(total, torch.zeros_like(total)))
        idx = torch.searchsorted(cdf, u, right=True).clamp(
            max=w.shape[0] - 1)  # all-zero weights: no row carries mass
        theta = params["thetas"][idx]
        z = torch.randn(n, theta.shape[1], generator=generator,
                        device=w.device)
        return theta + z @ params["chol"].T

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
