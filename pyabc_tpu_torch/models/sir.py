"""SIR epidemic ODE model (BASELINE config 4; ``pyabc_tpu/models/sir.py``
counterpart).

theta = (beta, gamma), the infection and recovery rates; the simulator
integrates with RK4 and returns the infected counts at fixed times,
``{"infected": (n_obs,)}``. With ``noise_sd = 0`` it is deterministic and
the observation noise is modelled by a stochastic kernel
(``IndependentNormalKernel`` + ``StochasticAcceptor`` + ``Temperature``,
noisy ABC). A proposal round goes through the K20 kernel
(``kernels/sir_simulate.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..core.sumstat_spec import SumStatSpec
from ..kernels.philox import PhiloxStream, generator_stream
from ..kernels.sir_simulate import sir_rhs, sir_simulate
from ..model import TorchModel
from .ode import rk4_dt

TRUE_PARS = {"beta": 0.4, "gamma": 0.1}
N_POP = 1000.0
Y0 = (N_POP - 1.0, 1.0, 0.0)

__all__ = ["N_POP", "TRUE_PARS", "Y0", "SIRModel", "default_prior",
           "make_sir_model", "observed_data", "sir_rhs"]


class SIRModel(TorchModel):
    """The SIR simulator; ``simulate_flat`` launches K20 on CUDA tensors."""

    def __init__(self, n_obs: int = 15, t1: float = 60.0,
                 n_substeps: int = 8, noise_sd: float = 0.0,
                 name: str = "sir"):
        self.n_obs = int(n_obs)
        self.n_substeps = int(n_substeps)
        self.noise_sd = float(noise_sd)
        self.dt = rk4_dt(np.linspace(0.0, t1, n_obs), n_substeps)
        super().__init__(self._sim_dict, ["beta", "gamma"], name=name)

    def simulate(self, theta: torch.Tensor,
                 stream: PhiloxStream | None = None) -> torch.Tensor:
        """``(B, 2)`` -> ``(B, n_obs)`` infected counts (noise, if any, from
        ``stream``)."""
        return sir_simulate(theta.contiguous(), n_obs=self.n_obs,
                            n_substeps=self.n_substeps, dt=self.dt,
                            n_pop=N_POP, noise_sd=self.noise_sd,
                            stream=stream)

    def _stream_for(self, generator, device) -> PhiloxStream | None:
        return (generator_stream(generator, device) if self.noise_sd > 0
                else None)

    def _sim_dict(self, theta, generator):
        return {"infected": self.simulate(
            theta, self._stream_for(generator, theta.device))}

    def simulate_flat(self, theta, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None):
        if spec.names != ("infected",) or spec.total_size != self.n_obs:
            return super().simulate_flat(theta, generator, spec)
        if stream is None:
            stream = self._stream_for(generator, theta.device)
        return self.simulate(theta, stream if self.noise_sd > 0 else None)


def make_sir_model(n_obs: int = 15, t1: float = 60.0, n_substeps: int = 8,
                   noise_sd: float = 0.0, name: str = "sir") -> SIRModel:
    return SIRModel(n_obs, t1, n_substeps, noise_sd, name)


def default_prior() -> Distribution:
    return Distribution(
        beta=RV("uniform", 0.05, 0.95),
        gamma=RV("uniform", 0.01, 0.49),
    )


def observed_data(seed: int = 0, n_obs: int = 15, t1: float = 60.0,
                  noise_sd: float = 10.0) -> dict:
    """Observation at TRUE_PARS with iid normal measurement noise from
    numpy's generator seeded with ``seed``, as the JAX package draws it
    (so both packages' observations differ only by the float32 RK4)."""
    model = make_sir_model(n_obs, t1, noise_sd=0.0)
    theta = torch.tensor([[TRUE_PARS["beta"], TRUE_PARS["gamma"]]],
                         dtype=torch.float32)
    infected = model.simulate(theta)[0].numpy()
    rng = np.random.default_rng(seed)
    return {"infected": infected + noise_sd * rng.normal(size=infected.shape)}
