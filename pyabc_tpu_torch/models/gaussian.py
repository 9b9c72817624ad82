"""Conjugate Gaussian toy models (``pyabc_tpu/models/gaussian.py``
counterpart): the correctness anchor with a closed-form posterior."""
from __future__ import annotations

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..model import TorchModel

PRIOR_MU_SD = 1.0
PRIOR_SD = (0.2, 1.5)  # uniform band for sigma
NOISE_N = 10  # iid observations per simulation


def gaussian_sim(theta: torch.Tensor, z: torch.Tensor) -> dict:
    """``make_gaussian_model``'s simulator on given standard normals
    ``z (B, n)``: mean and (population) std of mu + |sigma| z."""
    mu, sigma = theta[:, 0:1], theta[:, 1:2].abs()
    x = mu + sigma * z
    return {"mean": x.mean(dim=1), "std": x.std(dim=1, correction=0)}


def make_gaussian_model(n: int = NOISE_N, name: str = "gaussian"
                        ) -> TorchModel:
    """theta = (mu, sigma); returns mean/std of n iid N(mu, sigma) draws."""

    def sim(theta, generator):
        z = torch.randn(theta.shape[0], n, generator=generator,
                        device=theta.device)
        return gaussian_sim(theta, z)

    return TorchModel(sim, ["mu", "sigma"], name=name)


def default_prior() -> Distribution:
    return Distribution(
        mu=RV("norm", 0.0, PRIOR_MU_SD),
        sigma=RV("uniform", PRIOR_SD[0], PRIOR_SD[1] - PRIOR_SD[0]),
    )


def mean_only_sim(theta: torch.Tensor, z: torch.Tensor,
                  noise_sd: float) -> dict:
    """``make_mean_only_model``'s simulator on given normals ``z (B,)``."""
    return {"x": theta[:, 0] + noise_sd * z}


def make_mean_only_model(noise_sd: float = 0.5, name: str = "gauss1d"
                         ) -> TorchModel:
    """1-parameter model: x | theta ~ N(theta, noise_sd^2)."""

    def sim(theta, generator):
        z = torch.randn(theta.shape[0], generator=generator,
                        device=theta.device)
        return mean_only_sim(theta, z, noise_sd)

    return TorchModel(sim, ["theta"], name=name)


def mean_only_prior() -> Distribution:
    return Distribution(theta=RV("norm", 0.0, 1.0))


def conjugate_posterior(x_obs: float, noise_sd: float = 0.5,
                        prior_sd: float = 1.0) -> tuple[float, float]:
    var = 1.0 / (1.0 / prior_sd**2 + 1.0 / noise_sd**2)
    return var * x_obs / noise_sd**2, float(np.sqrt(var))
