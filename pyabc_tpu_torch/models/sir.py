"""SIR epidemic ODE model (BASELINE config 4; ``pyabc_tpu/models/sir.py``
counterpart).

theta = (beta, gamma), the infection and recovery rates; the simulator
integrates with RK4 and returns the infected counts at fixed times,
``{"infected": (n_obs,)}``. With ``noise_sd = 0`` it is deterministic and
the observation noise is modelled by a stochastic kernel
(``IndependentNormalKernel`` + ``StochasticAcceptor`` + ``Temperature``,
noisy ABC). A proposal round goes through the K20 kernel
(``kernels/sir_simulate.py``).

``make_network_sir_model`` is the scenario zoo's metapopulation SIR: 8
ring-coupled patches observed at 16 times (S = 128), built on the segmented
protocol (4 segments) and run by the K20b network kernel
(``kernels/network_sir.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..core.sumstat_spec import SumStatSpec
from ..kernels.network_sir import NetworkSirSpec, network_sir
from ..kernels.philox import PhiloxStream, generator_stream
from ..kernels.sir_simulate import sir_rhs, sir_simulate
from ..model import ChainModel, TorchModel
from ..ops.segment import spec_protocol
from .ode import rk4_dt

TRUE_PARS = {"beta": 0.4, "gamma": 0.1}
N_POP = 1000.0
Y0 = (N_POP - 1.0, 1.0, 0.0)

__all__ = ["N_POP", "TRUE_PARS", "Y0", "SIRModel", "default_prior",
           "make_network_sir_model", "make_sir_model", "network_sir_prior",
           "observed_data", "observed_network_sir", "sir_rhs"]


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


# --------------------------------------------------------------------------
# network / metapopulation SIR (the scenario zoo): n_patches coupled SIR
# compartments integrated together, observing every patch's infected
# series (S = n_obs * n_patches), built on the segmented protocol.
# --------------------------------------------------------------------------

def make_network_sir_model(n_patches: int = 8, n_obs: int = 16,
                           t1: float = 60.0, n_substeps: int = 4,
                           coupling: float = 0.08, segments: int = 4,
                           noise_sd: float = 0.0,
                           name: str = "network_sir") -> ChainModel:
    """Ring-coupled metapopulation SIR; theta = (beta, gamma) global.

    Patch 0 seeds the epidemic (5 infected of 1000); infection pressure on
    a patch mixes its prevalence with its ring neighbours' (``coupling``).
    Returns ``{"infected": (n_obs * n_patches,)}``, time-major, so a
    trajectory prefix is a flat prefix. ``noise_sd > 0`` adds measurement
    noise inside the simulator, per segment."""
    if n_obs % segments:
        raise ValueError(f"segments={segments} must divide n_obs={n_obs}")
    spec = NetworkSirSpec(n_patches=int(n_patches), n_obs=int(n_obs),
                          t1=float(t1), n_substeps=int(n_substeps),
                          coupling=float(coupling), n_seg=int(segments),
                          noise_sd=float(noise_sd), n_pop=N_POP)
    chain = spec_protocol(spec, (("infected", spec.seg_size),), network_sir)
    return ChainModel(chain, ["beta", "gamma"], name, segmented=True)


def network_sir_prior() -> Distribution:
    return Distribution(
        beta=RV("uniform", 0.05, 0.95),
        gamma=RV("uniform", 0.01, 0.49),
    )


def observed_network_sir(seed: int = 0, noise_sd: float = 8.0,
                         **kwargs) -> dict:
    """The deterministic network SIR at TRUE_PARS plus iid normal
    measurement noise from numpy's generator seeded with ``seed``, as the
    JAX package draws it."""
    model = make_network_sir_model(**kwargs)
    theta = torch.tensor([[TRUE_PARS["beta"], TRUE_PARS["gamma"]]],
                         dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    infected = model.sim(theta, gen)["infected"][0].numpy()
    rng = np.random.default_rng(seed)
    return {"infected": infected + noise_sd * rng.normal(size=infected.shape)}
