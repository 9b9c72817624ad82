"""Model selection (BASELINE config 5; ``pyabc_tpu/models/model_selection.py``
counterpart).

- ``tractable_pair()``: two conjugate Gaussian models with different
  noise scales (``gaussian.make_mean_only_model``, K4's mean-only kernel);
  their posterior model probabilities are exact, the statistical anchor of
  a run over several models.
- ``ode_family()``: the K = 3 nested ODE models (decay, decay +
  production, logistic) of one observation. They are one built-in
  multi-model simulator: a round's lanes, each with its own model index,
  go through the K20b kernel (``kernels/ode_family.py``) in one launch.
  ``ode_family(segments=K)`` builds every model through the segmented
  protocol (observations at the ``n_obs`` times after t = 0, rates padded
  to 2): the family's range kernel (``ode_family_segments``) serves the
  classic path in one launch, and K18 steps each slot's own model a
  segment at a time under early reject.

``observed_ode_family`` draws its observation noise from numpy's
generator (a declared difference: the JAX package draws it with
``jax.random``), so tests compare the packages on the JAX observation.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..core.sumstat_spec import SumStatSpec
from ..kernels.ode_family import (MODEL_NAMES, OdeFamilySegSpec,
                                  ode_family_segments, ode_family_simulate)
from ..kernels.philox import PhiloxStream, generator_stream
from ..model import ChainModel, TorchModel
from ..ops.segment import spec_protocol
from .gaussian import make_mean_only_model
from .ode import rk4_dt

#: initial state of every model of the family
Y0 = 2.0
#: the true parameters of observed_ode_family, by model
TRUE_THETA = {0: [0.4], 1: [0.4, 0.5], 2: [0.5, 6.0]}
_PARAMS = (["a"], ["a", "b"], ["a", "k"])


def tractable_pair(noise_sds=(0.6, 1.2), prior_sd: float = 1.0):
    """Two models x ~ N(theta, sd_m^2), theta ~ N(0, prior_sd^2). The
    marginal likelihood of model m at x0 is N(x0; 0, prior_sd^2 + sd_m^2),
    so the posterior model probabilities are exact. Returns (models,
    priors, analytic_posterior(x0))."""
    models = [make_mean_only_model(sd, name=f"gauss_sd{i}")
              for i, sd in enumerate(noise_sds)]
    priors = [Distribution(theta=RV("norm", 0.0, prior_sd))
              for _sd in noise_sds]

    def analytic_posterior(x0: float) -> np.ndarray:
        var = np.asarray([prior_sd ** 2 + sd ** 2 for sd in noise_sds])
        evid = np.exp(-0.5 * x0 ** 2 / var) / np.sqrt(2 * math.pi * var)
        return evid / evid.sum()

    return models, priors, analytic_posterior


class OdeFamily:
    """The simulator shared by the family's models: ``simulate_flat``
    takes each lane's model index and launches K20b once for the round."""

    def __init__(self, n_obs: int = 12, t1: float = 8.0,
                 noise_sd: float = 0.3, n_substeps: int = 6):
        self.n_obs = int(n_obs)
        self.n_substeps = int(n_substeps)
        self.noise_sd = float(noise_sd)
        self.ts = np.linspace(0.0, t1, n_obs)
        self.dt = rk4_dt(self.ts, n_substeps)

    def simulate(self, theta: torch.Tensor, m: torch.Tensor,
                 stream: PhiloxStream | None = None,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
        """``(B, >= 1)`` parameters and ``m (B,)`` int32 -> ``(B, n_obs)``
        (the noise from ``stream``, or given to the plain version)."""
        return ode_family_simulate(
            theta.contiguous(), m, n_obs=self.n_obs,
            n_substeps=self.n_substeps, dt=self.dt, y0=Y0,
            noise_sd=self.noise_sd, stream=stream, noise=noise)

    def simulate_flat(self, theta, m, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None) -> torch.Tensor:
        if spec.names != ("y",) or spec.total_size != self.n_obs:
            raise ValueError("the ODE family's observation is {'y': "
                             f"({self.n_obs},)}}")
        if stream is None and self.noise_sd > 0:
            stream = generator_stream(generator, theta.device)
        return self.simulate(theta, m, stream)


class OdeFamilyModel(TorchModel):
    """One model of the family; alone it simulates every lane as model
    ``index``, in a run with its siblings the family simulates the round."""

    def __init__(self, family: OdeFamily, index: int):
        self.family = family
        self.index = int(index)
        super().__init__(self._sim_dict, _PARAMS[index],
                         name=MODEL_NAMES[index])

    def _model_of(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.full((theta.shape[0],), self.index, dtype=torch.int32,
                          device=theta.device)

    def _sim_dict(self, theta, generator):
        stream = (generator_stream(generator, theta.device)
                  if self.family.noise_sd > 0 else None)
        return {"y": self.family.simulate(theta, self._model_of(theta),
                                          stream)}

    def simulate_flat(self, theta, generator, spec: SumStatSpec,
                      stream=None):
        return self.family.simulate_flat(theta, self._model_of(theta),
                                         generator, spec, stream)


class SegmentedOdeFamily:
    """The segmented family's shared simulator: ``simulate_flat`` takes
    each lane's model index and launches the family's range kernel once
    for the round (every segment)."""

    def __init__(self, n_obs: int, t1: float, noise_sd: float,
                 segments: int, n_substeps: int):
        if segments < 1 or n_obs % segments:
            raise ValueError(f"segments={segments} must divide "
                             f"n_obs={n_obs}")
        self.n_obs = int(n_obs)
        self.noise_sd = float(noise_sd)
        self.specs = tuple(
            OdeFamilySegSpec(variant=i, n_obs=int(n_obs), t1=float(t1),
                             n_substeps=int(n_substeps), n_seg=int(segments),
                             noise_sd=float(noise_sd), y0=Y0)
            for i in range(len(MODEL_NAMES)))
        self.ts = np.linspace(0.0, t1, n_obs + 1)[1:]

    def simulate_flat(self, theta, m, generator, spec: SumStatSpec,
                      stream: PhiloxStream | None = None) -> torch.Tensor:
        if spec.names != ("y",) or spec.total_size != self.n_obs:
            raise ValueError("the ODE family's observation is {'y': "
                             f"({self.n_obs},)}}")
        if stream is None:
            stream = generator_stream(generator, theta.device)
        return ode_family_segments(self.specs, theta.contiguous(), stream,
                                   m=m)[0]

    def observe(self, theta: torch.Tensor, index: int,
                noise: torch.Tensor) -> torch.Tensor:
        """Model ``index``'s noiseless chain at ``theta`` plus the given
        noise, added as the step adds its own."""
        quiet = replace(self.specs[index], noise_sd=0.0)
        st = PhiloxStream(0, 0, 0, 1, torch.zeros(4, dtype=torch.int32))
        y = ode_family_segments(quiet, theta, st)[0]
        return y + self.noise_sd * noise


class SegmentedFamilyModel(ChainModel):
    """One model of the segmented family; in a run with its siblings the
    family simulates the round, alone it runs its own chain."""

    def __init__(self, family: SegmentedOdeFamily, index: int):
        spec = family.specs[index]
        chain = spec_protocol(spec, (("y", spec.obs_per_seg),),
                              ode_family_segments)
        super().__init__(chain, _PARAMS[index], MODEL_NAMES[index],
                         segmented=True)
        self.family = family
        self.index = int(index)


def ode_family(n_obs: int = 12, t1: float = 8.0, noise_sd: float = 0.3,
               segments: int | None = None, n_substeps: int = 6):
    """The K = 3 nested ODE models for y(t), observed with noise at the
    ``n_obs`` times of [0, t1]: m0 dy = -a y, m1 dy = -a y + b, m2 dy =
    a y (1 - y / k). ``segments=K`` declares the segmented protocol (early
    reject): the observations are then the ``n_obs`` times after t = 0.
    Returns (models, priors, ts)."""
    if segments is not None:
        family = SegmentedOdeFamily(n_obs, t1, noise_sd, segments,
                                    n_substeps)
        models = [SegmentedFamilyModel(family, i)
                  for i in range(len(MODEL_NAMES))]
        return models, _family_priors(), family.ts
    family = OdeFamily(n_obs, t1, noise_sd, n_substeps)
    models = [OdeFamilyModel(family, i) for i in range(len(MODEL_NAMES))]
    return models, _family_priors(), family.ts


def _family_priors() -> list:
    return [
        Distribution(a=RV("uniform", 0.05, 1.0)),
        Distribution(a=RV("uniform", 0.05, 1.0), b=RV("uniform", 0.0, 1.0)),
        Distribution(a=RV("uniform", 0.05, 1.0), k=RV("uniform", 1.0, 9.0)),
    ]


def observed_ode_family(seed: int = 0, true_model: int = 1,
                        n_obs: int = 12, t1: float = 8.0,
                        noise_sd: float = 0.3,
                        segments: int | None = None) -> dict:
    """The observation of ``true_model`` at TRUE_THETA, its noise from
    numpy's generator seeded with ``seed``."""
    models, _priors, _ts = ode_family(n_obs, t1, noise_sd,
                                      segments=segments)
    family = models[true_model].family
    theta = torch.tensor([TRUE_THETA[true_model]], dtype=torch.float32)
    noise = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, n_obs)).astype(np.float32))
    if segments is not None:
        return {"y": family.observe(theta, true_model, noise)[0].numpy()}
    m = torch.full((1,), true_model, dtype=torch.int32)
    return {"y": family.simulate(theta, m, noise=noise)[0].numpy()}
