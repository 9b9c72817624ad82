"""Lotka-Volterra predator-prey ODE model (BASELINE config 2;
``pyabc_tpu/models/lotka_volterra.py`` counterpart).

theta = (alpha, beta, gamma, delta); the simulator integrates with RK4
and returns noisy trajectories {"prey": (n_obs,), "pred": (n_obs,)}. A
proposal round goes through the K4 kernel (``kernels/lv_simulate.py``),
which draws the observation noise from the round's Philox stream.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..core.sumstat_spec import SumStatSpec
from ..kernels.lv_simulate import lv_rhs, lv_simulate
from ..kernels.philox import PhiloxStream, generator_stream
from ..model import TorchModel
from .ode import rk4_dt

#: default true parameters (classic textbook values)
TRUE_PARS = {"alpha": 1.0, "beta": 0.1, "gamma": 1.5, "delta": 0.075}
Y0 = (10.0, 5.0)

__all__ = ["TRUE_PARS", "Y0", "LotkaVolterraModel", "lv_rhs",
           "make_lv_model", "default_prior", "observed_data"]


class LotkaVolterraModel(TorchModel):
    """The LV simulator; ``simulate_flat`` launches K4 on CUDA tensors."""

    def __init__(self, n_obs: int = 20, t1: float = 15.0,
                 n_substeps: int = 10, noise_sd: float = 0.5,
                 log_parameters: bool = False,
                 name: str = "lotka_volterra"):
        self.n_obs = int(n_obs)
        self.n_substeps = int(n_substeps)
        self.noise_sd = float(noise_sd)
        self.log_parameters = bool(log_parameters)
        self.dt = rk4_dt(np.linspace(0.0, t1, n_obs), n_substeps)
        super().__init__(self._sim_dict,
                         ["alpha", "beta", "gamma", "delta"], name=name)

    #: a simulator-noise stream for a call outside the rounds
    generator_stream = staticmethod(generator_stream)

    def simulate_with_noise(self, theta: torch.Tensor,
                            noise: torch.Tensor | None,
                            stream: PhiloxStream | None = None
                            ) -> torch.Tensor:
        """``(B, 2 * n_obs)`` rows, ``pred | prey``, on noise drawn from
        ``stream`` or, on the CPU only, on the given ``noise``."""
        return lv_simulate(
            theta.contiguous(), noise, n_obs=self.n_obs,
            n_substeps=self.n_substeps, dt=self.dt, y0=Y0,
            noise_sd=self.noise_sd, log_parameters=self.log_parameters,
            stream=stream)

    def _split(self, flat: torch.Tensor) -> dict:
        return {"pred": flat[:, : self.n_obs], "prey": flat[:, self.n_obs:]}

    def _sim_dict(self, theta, generator):
        return self._split(self.simulate_with_noise(
            theta, None, self.generator_stream(generator, theta.device)))

    def simulate_flat(self, theta, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None):
        if spec.names != ("pred", "prey") or spec.total_size != 2 * self.n_obs:
            return super().simulate_flat(theta, generator, spec)
        if stream is None:
            stream = self.generator_stream(generator, theta.device)
        return self.simulate_with_noise(theta, None, stream)


def make_lv_model(n_obs: int = 20, t1: float = 15.0, n_substeps: int = 10,
                  noise_sd: float = 0.5, log_parameters: bool = False,
                  name: str = "lotka_volterra") -> LotkaVolterraModel:
    return LotkaVolterraModel(n_obs, t1, n_substeps, noise_sd,
                              log_parameters, name)


def default_prior(log_parameters: bool = False) -> Distribution:
    if log_parameters:
        return Distribution(
            alpha=RV("uniform", -1.0, 1.3),
            beta=RV("uniform", -2.0, 1.3),
            gamma=RV("uniform", -1.0, 1.6),
            delta=RV("uniform", -2.5, 1.5),
        )
    return Distribution(
        alpha=RV("uniform", 0.0, 3.0),
        beta=RV("uniform", 0.0, 0.5),
        gamma=RV("uniform", 0.0, 3.0),
        delta=RV("uniform", 0.0, 0.3),
    )


def observed_data(seed: int = 0, n_obs: int = 20, t1: float = 15.0,
                  n_substeps: int = 10, noise_sd: float = 0.5) -> dict:
    """Observation at TRUE_PARS. The noise comes from numpy's generator
    seeded with ``seed`` (the JAX package draws it with jax.random, so the
    two packages' observations differ in their noise, not in the ODE)."""
    model = make_lv_model(n_obs, t1, n_substeps, noise_sd)
    theta = torch.tensor([[TRUE_PARS[k] for k in
                           ("alpha", "beta", "gamma", "delta")]],
                         dtype=torch.float32)
    noise = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((1, 2, n_obs))
        .astype(np.float32))
    flat = model.simulate_with_noise(theta, noise)[0].numpy()
    return {"pred": flat[:n_obs].copy(), "prey": flat[n_obs:].copy()}
