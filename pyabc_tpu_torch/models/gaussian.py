"""Conjugate Gaussian toy models (``pyabc_tpu/models/gaussian.py``
counterpart): the correctness anchor with a closed-form posterior.

``make_gaussian_model`` (BASELINE config 1) simulates a proposal round
through K4's Gaussian kernel (``kernels/gaussian_simulate.py``) and
``make_mean_only_model`` (the conjugate toy) through K4's mean-only
kernel, both drawing their normals from the round's Philox stream at each
lane's global number.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..core.sumstat_spec import SumStatSpec
from ..kernels.gaussian_simulate import gaussian_simulate, mean_only_simulate
from ..kernels.philox import PhiloxStream, generator_stream
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


class GaussianModel(TorchModel):
    """theta = (mu, sigma) -> mean and std of n iid N(mu, sigma) draws;
    every simulation, a round's rows and a user's call alike, is K4's
    Gaussian kernel, which writes the observed statistics in spec order."""

    def __init__(self, n: int = NOISE_N, name: str = "gaussian"):
        self.n = int(n)
        super().__init__(self._sim_dict, ["mu", "sigma"], name=name)

    def _sim_dict(self, theta, generator):
        rows = gaussian_simulate(
            theta.contiguous(), n=self.n,
            stream=generator_stream(generator, theta.device))
        return {"mean": rows[:, 0], "std": rows[:, 1]}

    def simulate_flat(self, theta, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None):
        missing = set(spec.names) - {"mean", "std"}
        if missing:
            raise KeyError(f"{self.name}: simulator output lacks "
                           f"{sorted(missing)} of the observed data")
        if any(spec.sizes[k] != 1 for k in spec.names):
            raise ValueError(f"{self.name}: mean and std are scalars, the "
                             f"observation has {dict(spec.shapes)}")
        if stream is None:
            stream = generator_stream(generator, theta.device)
        columns = tuple(spec.offsets.get(k, -1) for k in ("mean", "std"))
        return gaussian_simulate(theta.contiguous(), n=self.n, stream=stream,
                                 columns=columns)


def make_gaussian_model(n: int = NOISE_N, name: str = "gaussian"
                        ) -> GaussianModel:
    """theta = (mu, sigma); returns mean/std of n iid N(mu, sigma) draws."""
    return GaussianModel(n, name)


def default_prior() -> Distribution:
    return Distribution(
        mu=RV("norm", 0.0, PRIOR_MU_SD),
        sigma=RV("uniform", PRIOR_SD[0], PRIOR_SD[1] - PRIOR_SD[0]),
    )


def mean_only_sim(theta: torch.Tensor, z: torch.Tensor,
                  noise_sd: float) -> dict:
    """``make_mean_only_model``'s simulator on given normals ``z (B,)``."""
    return {"x": theta[:, 0] + noise_sd * z}


class MeanOnlyGaussianModel(TorchModel):
    """theta -> x ~ N(theta, noise_sd^2); every simulation, a round's rows
    and a user's call alike, is K4's mean-only kernel."""

    def __init__(self, noise_sd: float = 0.5, name: str = "gauss1d"):
        self.noise_sd = float(noise_sd)
        super().__init__(self._sim_dict, ["theta"], name=name)

    def _sim_dict(self, theta, generator):
        rows = mean_only_simulate(
            theta.contiguous(), noise_sd=self.noise_sd,
            stream=generator_stream(generator, theta.device))
        return {"x": rows[:, 0]}

    def simulate_flat(self, theta, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None):
        missing = set(spec.names) - {"x"}
        if missing:
            raise KeyError(f"{self.name}: simulator output lacks "
                           f"{sorted(missing)} of the observed data")
        if spec.sizes["x"] != 1:
            raise ValueError(f"{self.name}: x is a scalar, the observation "
                             f"has {dict(spec.shapes)}")
        if stream is None:
            stream = generator_stream(generator, theta.device)
        return mean_only_simulate(theta.contiguous(), noise_sd=self.noise_sd,
                                  stream=stream)


def make_mean_only_model(noise_sd: float = 0.5, name: str = "gauss1d"
                         ) -> MeanOnlyGaussianModel:
    """1-parameter model: x | theta ~ N(theta, noise_sd^2)."""
    return MeanOnlyGaussianModel(noise_sd, name)


def mean_only_prior() -> Distribution:
    return Distribution(theta=RV("norm", 0.0, 1.0))


def conjugate_posterior(x_obs: float, noise_sd: float = 0.5,
                        prior_sd: float = 1.0) -> tuple[float, float]:
    var = 1.0 / (1.0 / prior_sd**2 + 1.0 / noise_sd**2)
    return var * x_obs / noise_sd**2, float(np.sqrt(var))
