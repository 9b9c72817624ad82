"""Stochastic chemical kinetics by tau leaping (BASELINE config 3;
``pyabc_tpu/models/gillespie.py`` counterpart).

Exact SSA has a data-dependent event count; the port ships tau leaping
with a fixed leap count, as the JAX package does: Poisson firing numbers
per reaction channel per leap, with a midpoint (second-order) variant. Two
built-in systems, birth-death and the stochastic Lotka-Volterra network,
run on the K19 kernel (``kernels/tau_leap.py``); ``tau_leap`` and
``tau_leap_segmented`` serve a user's own network in plain torch.

``segments=K`` factors the leap chain into K fixed-length segments (the
protocol of segmented early reject, ``ops/segment.py``); the classic path
then runs the same chain in one launch. A draw sits at (slot, leap,
channel) of the simulator-noise Philox stream, so the segmented and the
unsegmented constructors give the same numbers (a declared difference: the
JAX package keys them with ``fold_in`` and ``split``, and its bits are
jax.random's). The observations are drawn on a Philox stream keyed by the
seed, so they differ from the JAX package's in the noise; the tests compare
on the JAX observation.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.random_variables import RV, Distribution
from ..kernels.philox import PhiloxStream
from ..kernels.tau_leap import (BIRTH_DEATH, STOCHASTIC_LV, TauLeapSpec,
                                tau_leap as tau_leap_kernel,
                                tau_leap_leaps)
from ..model import ChainModel
from ..ops.segment import SegmentedSim, spec_protocol

__all__ = ["birth_death_prior", "make_birth_death_model",
           "make_stochastic_lv_model", "observed_birth_death",
           "observed_stochastic_lv", "stochastic_lv_prior", "tau_leap",
           "tau_leap_segmented"]


def _columns(a) -> list:
    return list(a.unbind(1)) if isinstance(a, torch.Tensor) else list(a)


def tau_leap(stream: PhiloxStream, x0: torch.Tensor, stoich,
             propensity_fn: Callable, t1: float, n_leaps: int,
             save_every: int = 1, midpoint: bool = False) -> torch.Tensor:
    """Tau leaping of a batch of lanes in plain torch.

    ``x0``: ``(B, n_species)`` initial counts; ``stoich``: ``(n_reactions,
    n_species)``; ``propensity_fn(x (B, n_species)) -> (B, n_reactions)``
    nonnegative rates (or a list of ``(B,)`` columns); ``n_leaps`` fixed
    leaps of tau = t1 / n_leaps; ``save_every`` must divide ``n_leaps``.
    Lane b's draws sit at lane b of ``stream``. Returns the ``(B, n_saved,
    n_species)`` post-leap states."""
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    if n_leaps % save_every:
        raise ValueError(
            f"save_every={save_every} does not divide n_leaps={n_leaps}: "
            f"the saved trajectory would silently drop the trailing "
            f"{n_leaps % save_every} leap(s)")
    stoich = tuple(tuple(float(v) for v in row) for row in
                   np.asarray(stoich, np.float64))
    x0 = torch.as_tensor(x0, dtype=torch.float32)
    lanes = torch.arange(x0.shape[0], dtype=torch.int64, device=x0.device)
    _x, saved = tau_leap_leaps(
        x0, None, lambda x, _r: _columns(propensity_fn(x)), stoich,
        tau=t1 / n_leaps, midpoint=midpoint, stream=stream, lanes=lanes,
        first_leap=0, n_leaps=n_leaps, save_every=save_every)
    return torch.stack(saved, dim=1)


def _check_obs_grid(n_leaps: int, n_obs: int, segments: int | None) -> int:
    """Validate the leap/observation/segment grid; returns save_every."""
    if n_leaps % n_obs:
        raise ValueError(
            f"n_obs={n_obs} does not divide n_leaps={n_leaps}: the "
            f"implied save_every would silently yield a wrong-length "
            f"trajectory — pick n_obs | n_leaps")
    if segments is not None:
        if segments < 1:
            raise ValueError(f"segments must be >= 1, got {segments}")
        if n_obs % segments or n_leaps % segments:
            raise ValueError(
                f"segments={segments} must divide both n_obs={n_obs} "
                f"and n_leaps={n_leaps} (each segment emits a whole "
                f"block of observations)")
    return n_leaps // n_obs


class _UserNetwork:
    """A user's reaction network cut into segments (plain torch steps)."""

    def __init__(self, x0, stoich, prop, rates_of, t1, n_leaps, n_obs,
                 segments, channels, midpoint):
        self.x0 = tuple(float(v) for v in x0)
        self.stoich = tuple(tuple(float(v) for v in row) for row in
                            np.asarray(stoich, np.float64))
        self.prop, self.rates_of = prop, rates_of
        self.tau = t1 / n_leaps
        self.n_seg = segments
        self.save_every = n_leaps // n_obs
        self.leaps_per_seg = n_leaps // segments
        self.channels, self.midpoint = tuple(channels), midpoint

    def initial_state(self, B: int, device) -> torch.Tensor:
        return torch.tensor(self.x0, dtype=torch.float32,
                            device=device).expand(B, len(self.x0)).clone()

    def lane_params(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.rates_of(theta), dtype=torch.float32)

    def step(self, x, rates, seg, stream, lanes):
        x, saved = tau_leap_leaps(
            x, rates, lambda xx, rr: _columns(self.prop(xx, rr)),
            self.stoich, tau=self.tau, midpoint=self.midpoint,
            stream=stream, lanes=lanes, first_leap=seg * self.leaps_per_seg,
            n_leaps=self.leaps_per_seg, save_every=self.save_every)
        vals = torch.cat([torch.stack([s[:, si] for s in saved], dim=1)
                          for _name, si in self.channels], dim=1)
        return x, vals


def tau_leap_segmented(*, x0: Sequence[float], stoich, prop: Callable,
                       rates_of: Callable, t1: float, n_leaps: int,
                       n_obs: int, segments: int, channels: tuple,
                       midpoint: bool = False) -> SegmentedSim:
    """Factor a user's tau-leap system into the segmented protocol.

    ``prop(x (B, n_species), rates (B, n_rates)) -> (B, n_reactions)`` and
    ``rates_of(theta (B, dim)) -> (B, n_rates)``; ``channels`` is a tuple
    of ``(stat_name, species_index)`` in emission order. The steps run in
    plain torch (on the card too, outside the early-reject round)."""
    _check_obs_grid(n_leaps, n_obs, segments)
    net = _UserNetwork(x0, stoich, prop, rates_of, t1, n_leaps, n_obs,
                       segments, channels, midpoint)
    layout = tuple((name, n_obs // segments) for name, _si in channels)
    proto = spec_protocol(net, layout, None)
    return SegmentedSim(n_segments=segments, init=proto.init,
                        step=proto.step, layout=layout)


# --------------------------------------------------------------------------
# canonical systems
# --------------------------------------------------------------------------

_BD_STOICH = ((1.0,), (-1.0,))
_LV_STOICH = (
    (1.0, 0.0),   # prey birth
    (-1.0, 1.0),  # predation converts prey to predator
    (0.0, -1.0),  # predator death
)


def _builtin(kind, x0, stoich, channels, params, *, t1, n_leaps, n_obs,
             segments, midpoint, name) -> ChainModel:
    _check_obs_grid(n_leaps, n_obs, segments)
    spec = TauLeapSpec(kind=kind, x0=x0, stoich=stoich, channels=channels,
                       t1=float(t1), n_leaps=int(n_leaps), n_obs=int(n_obs),
                       n_seg=int(segments or 1), midpoint=bool(midpoint))
    layout = tuple((ch, spec.obs_per_seg) for ch, _si in channels)
    chain = spec_protocol(spec, layout, tau_leap_kernel)
    return ChainModel(chain, params, name, segmented=segments is not None)


def make_birth_death_model(x0: float = 40.0, t1: float = 10.0,
                           n_leaps: int = 200, n_obs: int = 20,
                           segments: int | None = None,
                           midpoint: bool = False,
                           name: str = "birth_death") -> ChainModel:
    """Birth-death process: 0 ->(b) X, X ->(d) 0; theta = (log10 b, log10
    d) -> {"x": (n_obs,)}. ``segments=K`` declares the segmented protocol
    (early reject)."""
    return _builtin(BIRTH_DEATH, (float(x0),), _BD_STOICH, (("x", 0),),
                    ["log_b", "log_d"], t1=t1, n_leaps=n_leaps, n_obs=n_obs,
                    segments=segments, midpoint=midpoint, name=name)


def birth_death_prior() -> Distribution:
    return Distribution(
        log_b=RV("uniform", -1.0, 2.0),
        log_d=RV("uniform", -2.0, 2.0),
    )


def make_stochastic_lv_model(t1: float = 15.0, n_leaps: int = 300,
                             n_obs: int = 20,
                             segments: int | None = None,
                             midpoint: bool = False,
                             name: str = "stochastic_lv") -> ChainModel:
    """Stochastic Lotka-Volterra reaction network (3 channels): prey birth,
    predation, predator death; x = (prey, pred) from (50, 100); theta =
    log10 rates -> {"pred": (n_obs,), "prey": (n_obs,)}, emitted (pred,
    prey) per segment."""
    return _builtin(STOCHASTIC_LV, (50.0, 100.0), _LV_STOICH,
                    (("pred", 1), ("prey", 0)),
                    ["log_r1", "log_r2", "log_r3"], t1=t1, n_leaps=n_leaps,
                    n_obs=n_obs, segments=segments, midpoint=midpoint,
                    name=name)


def stochastic_lv_prior() -> Distribution:
    return Distribution(
        log_r1=RV("uniform", -1.0, 1.5),
        log_r2=RV("uniform", -3.0, 1.5),
        log_r3=RV("uniform", -1.0, 1.5),
    )


def _observe(model: ChainModel, theta, seed: int) -> dict:
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    out = model.sim(torch.tensor([theta], dtype=torch.float32), gen)
    return {k: v[0].numpy() for k, v in out.items()}


def observed_birth_death(seed: int = 0, **kwargs) -> dict:
    """One trajectory at log10 (b, d) = (1, -0.5), its draws on a Philox
    stream keyed by ``seed``."""
    return _observe(make_birth_death_model(**kwargs), [1.0, -0.5], seed)


def observed_stochastic_lv(seed: int = 0, **kwargs) -> dict:
    return _observe(make_stochastic_lv_model(**kwargs), [0.2, -1.9, 0.1],
                    seed)

