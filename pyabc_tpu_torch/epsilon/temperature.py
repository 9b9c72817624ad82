"""Temperature schedules for stochastic (noisy) ABC
(``pyabc_tpu/epsilon/temperature.py`` counterpart, a copy of its numpy
code plus the device descriptor).

With a `StochasticAcceptor`, epsilon(t) is a temperature T_t >= 1 on the
acceptance density: accept ~ exp((v - pdf_norm)/T). Temperature
orchestrates one or more schemes, takes the *minimum* (most aggressive)
proposal each generation, enforces monotone decay, and lands exactly at
T = 1 (exact sampling) on the final generation when the horizon is known.

The schemes' host ``__call__`` is the reference: on the device path the
initial temperature and every later one are computed by the K21b kernel
(``kernels/temperature_update.py``) from the ``TempConfig`` that
:func:`device_config` builds, and the host objects mirror the device trail
after each chunk's fetch.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..utils import not_ported
from .base import Epsilon

logger = logging.getLogger("ABC.Epsilon")


class TemperatureScheme:
    """Base: __call__(t, **ctx) -> proposed temperature."""

    def __call__(self, t: int, *, get_weighted_distances=None,
                 get_all_records=None,
                 pdf_norm: float | None = None, kernel_scale: str = "SCALE_LOG",
                 prev_temperature: float | None = None,
                 acceptance_rate: float | None = None,
                 max_nr_populations: int | None = None) -> float:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class AcceptanceRateScheme(TemperatureScheme):
    """Choose T so the *predicted* acceptance rate hits ``target_rate``
    (reference AcceptanceRateScheme).

    The prediction model: weighted mean over kernel values v_i of
    min(1, exp((v_i - pdf_norm)/T)); bisection on log10(T). Prefers the
    ALL-simulations record (accepted + rejected); falls back to the
    importance-weighted accepted set.

    Record reweighting (reference semantics): the records are distributed
    under generation t's *proposal*, while the rate being predicted is
    under generation t+1's proposal. When the record carries
    ``transition_pd_prev`` (density under the proposal it was drawn from)
    and ``transition_pd`` (density under the NEXT proposal, computed after
    the transition refit), each record is importance-reweighted by
    transition_pd / transition_pd_prev — correcting for the proposal shift
    between generations. Records without the columns fall back to uniform
    weights (one-generation-lag approximation).
    """

    def __init__(self, target_rate: float = 0.3):
        self.target_rate = float(target_rate)

    def __call__(self, t, *, get_weighted_distances=None, get_all_records=None,
                 pdf_norm=None, kernel_scale="SCALE_LOG",
                 prev_temperature=None, acceptance_rate=None,
                 max_nr_populations=None) -> float:
        if pdf_norm is None:
            return np.inf
        df = None
        if get_all_records is not None:
            df = get_all_records()
        if df is None or len(df) == 0:
            if get_weighted_distances is None:
                return np.inf
            df = get_weighted_distances()
        vals = np.asarray(df["distance"], np.float64)
        if kernel_scale == "SCALE_LIN":
            vals = np.log(np.maximum(vals, 1e-300))
        if "transition_pd_prev" in df and "transition_pd" in df:
            pd_prev = np.asarray(df["transition_pd_prev"], np.float64)
            pd_new = np.asarray(df["transition_pd"], np.float64)
            ok = np.isfinite(pd_prev) & (pd_prev > 0) & np.isfinite(pd_new)
            w = np.where(ok, pd_new / np.where(ok, pd_prev, 1.0), 0.0)
            if w.sum() <= 0:
                w = np.ones_like(vals)
        elif "w" in df:
            w = np.asarray(df["w"], np.float64)
        else:
            w = np.ones_like(vals)
        w = w / w.sum()
        diff = vals - pdf_norm  # <= 0 typically

        def rate_at(temp: float) -> float:
            return float(np.sum(w * np.minimum(1.0, np.exp(diff / temp))))

        # T=1 already accepts often enough -> no tempering needed
        if rate_at(1.0) >= self.target_rate:
            return 1.0
        lo, hi = 0.0, 12.0  # log10 T in [1, 1e12]
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if rate_at(10.0**mid) >= self.target_rate:
                hi = mid
            else:
                lo = mid
        return float(10.0**hi)


class ExpDecayFixedIterScheme(TemperatureScheme):
    """Exponential decay to T=1 over a fixed horizon (reference
    ExpDecayFixedIterScheme): log T linear in t, hitting 1 at the final
    generation."""

    def __call__(self, t, *, prev_temperature=None, max_nr_populations=None,
                 **ctx) -> float:
        if max_nr_populations is None:
            raise ValueError(
                "ExpDecayFixedIterScheme needs a fixed max_nr_populations"
            )
        if prev_temperature is None or not np.isfinite(prev_temperature):
            return np.inf
        t_to_go = max_nr_populations - t
        if t_to_go <= 1:
            return 1.0
        # geometric interpolation from prev temp to 1 over remaining gens
        return float(prev_temperature ** ((t_to_go - 1) / t_to_go))


class ExpDecayFixedRatioScheme(TemperatureScheme):
    """T_t = alpha * T_{t-1} (reference ExpDecayFixedRatioScheme)."""

    def __init__(self, alpha: float = 0.5, min_rate: float = 1e-4,
                 max_rate: float = 0.5):
        self.alpha = float(alpha)
        self.min_rate = min_rate
        self.max_rate = max_rate

    def __call__(self, t, *, prev_temperature=None, acceptance_rate=None,
                 **ctx) -> float:
        if prev_temperature is None or not np.isfinite(prev_temperature):
            return np.inf
        alpha = self.alpha
        if acceptance_rate is not None:
            # slow down when acceptance collapses, speed up when trivial
            if acceptance_rate < self.min_rate:
                alpha = np.sqrt(alpha)
            elif acceptance_rate > self.max_rate:
                alpha = alpha**2
        return float(max(1.0, alpha * prev_temperature))


class PolynomialDecayFixedIterScheme(TemperatureScheme):
    """T decays polynomially to 1 over a fixed horizon (reference
    PolynomialDecayFixedIterScheme)."""

    def __init__(self, exponent: float = 3.0):
        self.exponent = float(exponent)

    def __call__(self, t, *, prev_temperature=None, max_nr_populations=None,
                 **ctx) -> float:
        if max_nr_populations is None:
            raise ValueError(
                "PolynomialDecayFixedIterScheme needs max_nr_populations"
            )
        if prev_temperature is None or not np.isfinite(prev_temperature):
            return np.inf
        t_to_go = max_nr_populations - t
        if t_to_go <= 1:
            return 1.0
        frac = (t_to_go - 1) / t_to_go
        return float(1.0 + (prev_temperature - 1.0) * frac**self.exponent)


class DalyScheme(TemperatureScheme):
    """Daly et al. 2017 adaptive tolerance contraction (reference DalyScheme):
    keep an internal contraction state k; shrink it by ``alpha`` each
    generation, but react to acceptance-rate collapse by re-expanding."""

    def __init__(self, alpha: float = 0.5, min_rate: float = 1e-4):
        self.alpha = float(alpha)
        self.min_rate = float(min_rate)
        self._k: dict[int, float] = {}

    def __call__(self, t, *, prev_temperature=None, acceptance_rate=None,
                 **ctx) -> float:
        if prev_temperature is None or not np.isfinite(prev_temperature):
            return np.inf
        k_prev = self._k.get(t - 1, prev_temperature)
        if acceptance_rate is not None and acceptance_rate < self.min_rate:
            # back off: SHRINK the contraction step so temperature decreases
            # more slowly while acceptance recovers (reference Daly reaction;
            # dividing by alpha would double the decrement and cool faster,
            # worsening the collapse)
            k = self.alpha * k_prev
        else:
            k = self.alpha * min(k_prev, prev_temperature)
        self._k[t] = k
        return float(max(1.0, prev_temperature - k))


class FrielPettittScheme(TemperatureScheme):
    """Power-posterior tempering ladder beta_t = ((t+1)/n)^2, T = 1/beta
    (reference FrielPettittScheme)."""

    def __call__(self, t, *, max_nr_populations=None, **ctx) -> float:
        if max_nr_populations is None:
            raise ValueError("FrielPettittScheme needs max_nr_populations")
        beta = ((t + 1.0) / max_nr_populations) ** 2
        return float(1.0 / max(beta, 1e-12))


class EssScheme(TemperatureScheme):
    """Choose T so the relative ESS of the tempering reweight factors hits
    ``target_relative_ess`` (reference EssScheme)."""

    def __init__(self, target_relative_ess: float = 0.8):
        self.target_relative_ess = float(target_relative_ess)

    def __call__(self, t, *, get_weighted_distances=None, pdf_norm=None,
                 kernel_scale="SCALE_LOG", prev_temperature=None, **ctx
                 ) -> float:
        if get_weighted_distances is None:
            return np.inf
        df = get_weighted_distances()
        vals = np.asarray(df["distance"], np.float64)
        if kernel_scale == "SCALE_LIN":
            vals = np.log(np.maximum(vals, 1e-300))
        w = np.asarray(df["w"], np.float64) if "w" in df else np.ones_like(vals)
        w = w / w.sum()
        T_prev = (
            prev_temperature
            if prev_temperature is not None and np.isfinite(prev_temperature)
            else None
        )

        def rel_ess(temp: float) -> float:
            # reweight factor from T_prev (or prior) to temp
            beta_new = 1.0 / temp
            beta_old = 0.0 if T_prev is None else 1.0 / T_prev
            lw = (beta_new - beta_old) * vals
            lw = lw - lw.max()
            ww = w * np.exp(lw)
            s = ww.sum()
            if s <= 0:
                return 0.0
            ww = ww / s
            return float(1.0 / np.sum(ww**2) / len(ww))

        target = self.target_relative_ess
        if rel_ess(1.0) >= target:
            return 1.0
        lo, hi = 0.0, 12.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if rel_ess(10.0**mid) >= target:
                hi = mid
            else:
                lo = mid
        return float(10.0**hi)


class Temperature(Epsilon):
    """Adaptive temperature schedule (reference Temperature).

    ``schemes``: list of TemperatureScheme; the per-generation proposal is
    aggregated with ``aggregate_fun`` (default min) and clipped to enforce
    monotone decay and T >= 1. The final generation (known horizon) forces
    T = 1. Defaults follow the reference: AcceptanceRateScheme +
    ExpDecayFixedIterScheme.
    """

    def __init__(self, schemes: Sequence[TemperatureScheme] | None = None,
                 aggregate_fun: Callable = min,
                 initial_temperature: float | TemperatureScheme | None = None,
                 enforce_less_equal_prev: bool = True,
                 log_file: str | None = None):
        self.schemes = list(schemes) if schemes is not None else None
        self.aggregate_fun = aggregate_fun
        self.initial_temperature = (
            initial_temperature
            if initial_temperature is not None
            else AcceptanceRateScheme()
        )
        self.enforce_less_equal_prev = enforce_less_equal_prev
        self.log_file = log_file
        self.temperatures: dict[int, float] = {}
        self._max_nr_populations: int | None = None

    def requires_calibration(self) -> bool:
        return True

    def _effective_schemes(self) -> list[TemperatureScheme]:
        if self.schemes is not None:
            return self.schemes
        schemes: list[TemperatureScheme] = [AcceptanceRateScheme()]
        if self._max_nr_populations is not None:
            schemes.append(ExpDecayFixedIterScheme())
        else:
            schemes.append(ExpDecayFixedRatioScheme())
        return schemes

    def initialize(self, t, get_weighted_distances=None, get_all_records=None,
                   max_nr_populations=None, acceptor_config=None):
        self._max_nr_populations = max_nr_populations
        self._set(t, get_weighted_distances, acceptor_config,
                  acceptance_rate=None, get_all_records=get_all_records)

    def update(self, t, get_weighted_distances=None, get_all_records=None,
               acceptance_rate=None, acceptor_config=None):
        self._set(t, get_weighted_distances, acceptor_config, acceptance_rate,
                  get_all_records=get_all_records)

    def _set(self, t, get_weighted_distances, acceptor_config,
             acceptance_rate, get_all_records=None):
        acceptor_config = acceptor_config or {}
        pdf_norm = acceptor_config.get("pdf_norm")
        kernel_scale = acceptor_config.get("kernel_scale", "SCALE_LOG")
        prev = self.temperatures.get(t - 1)
        is_final = (
            self._max_nr_populations is not None
            and t >= self._max_nr_populations - 1
        )
        if is_final:
            temp = 1.0
        elif t == 0 or prev is None:
            init = self.initial_temperature
            if isinstance(init, (int, float)):
                temp = float(init)
            else:
                temp = init(
                    t, get_weighted_distances=get_weighted_distances,
                    get_all_records=get_all_records,
                    pdf_norm=pdf_norm, kernel_scale=kernel_scale,
                    prev_temperature=None, acceptance_rate=acceptance_rate,
                    max_nr_populations=self._max_nr_populations,
                )
            if not np.isfinite(temp):
                temp = 1e4  # reference-style high fallback start
        else:
            proposals = []
            for scheme in self._effective_schemes():
                try:
                    proposals.append(scheme(
                        t, get_weighted_distances=get_weighted_distances,
                        get_all_records=get_all_records,
                        pdf_norm=pdf_norm, kernel_scale=kernel_scale,
                        prev_temperature=prev,
                        acceptance_rate=acceptance_rate,
                        max_nr_populations=self._max_nr_populations,
                    ))
                except ValueError:
                    continue
            proposals = [p for p in proposals if np.isfinite(p)] or [prev]
            temp = float(self.aggregate_fun(proposals))
        if (self.enforce_less_equal_prev and prev is not None
                and np.isfinite(prev)):
            temp = min(temp, prev)
        temp = max(temp, 1.0)
        self.temperatures[t] = temp
        logger.debug("temperature t=%d: %.4g", t, temp)
        if self.log_file:
            import json

            with open(self.log_file, "w") as fh:
                json.dump({str(k): v for k, v in self.temperatures.items()},
                          fh, indent=1)

    def __call__(self, t: int) -> float:
        return self.temperatures[t]

    def get_config(self):
        return {"name": type(self).__name__}

    def __repr__(self):
        return f"Temperature(schemes={self.schemes})"


class ListTemperature(Epsilon):
    """Pre-specified temperature ladder (reference ListTemperature): the
    user supplies T_t for every generation; the last entry is typically 1
    for exact sampling. No calibration, no adaptation."""

    def __init__(self, values: Sequence[float]):
        self.values = [float(v) for v in values]
        #: mirror Temperature's attribute so StochasticAcceptor/telemetry
        #: code paths that read `.temperatures` work unchanged
        self.temperatures = {t: v for t, v in enumerate(self.values)}

    def requires_calibration(self) -> bool:
        return False

    def initialize(self, t, get_weighted_distances=None,
                   get_all_records=None, max_nr_populations=None,
                   acceptor_config=None):
        pass

    def update(self, t, get_weighted_distances=None, get_all_records=None,
               acceptance_rate=None, acceptor_config=None):
        pass

    def __call__(self, t: int) -> float:
        if t >= len(self.values):
            return self.values[-1]
        return self.values[t]

    def get_config(self):
        return {"name": type(self).__name__, "values": self.values}

    def __repr__(self):
        return f"ListTemperature({self.values})"


# ------------------------------------------------------------------ device
@dataclass(frozen=True)
class TempConfig:
    """What the K21b kernel needs of a run's temperature schedule and
    acceptor (``pyabc_tpu`` ``ABCSMC._temp_config``): the schemes as
    ``(name, *params)`` tuples (empty for a ListTemperature ladder), the
    horizon (-1: none), the kernel's log pdf maximum (None: use the
    running maximum found), whether the kernel returns linear densities,
    ScaledPDFNorm's ``(factor, alpha)`` or None, and the initial
    temperature's scheme, ``("acceptance_rate", target)`` or
    ``("constant", T0)``."""

    schemes: tuple
    max_np: int
    pdf_max: float | None
    lin: bool
    pdf_scaled: tuple | None
    initial: tuple

    @property
    def fixed(self) -> bool:
        """A ListTemperature ladder: the temperatures come from the host."""
        return not self.schemes

    @property
    def needs_logq_new(self) -> bool:
        """An acceptance-rate scheme reweights the record ring to the next
        proposal, which needs the ring's density under the refit."""
        return any(s[0] == "acceptance_rate" for s in self.schemes)


_SCHEME_NAMES = {
    "AcceptanceRateScheme": "acceptance_rate",
    "ExpDecayFixedIterScheme": "exp_decay_fixed_iter",
    "PolynomialDecayFixedIterScheme": "poly_decay_fixed_iter",
    "ExpDecayFixedRatioScheme": "exp_decay_fixed_ratio",
    "FrielPettittScheme": "friel_pettitt",
    "DalyScheme": "daly",
    "EssScheme": "ess",
}
_NEED_HORIZON = {"exp_decay_fixed_iter", "poly_decay_fixed_iter",
                 "friel_pettitt"}


def _scheme_tuple(sch) -> tuple:
    name = _SCHEME_NAMES.get(type(sch).__name__)
    if name is None:
        raise not_ported(f"temperature scheme {type(sch).__name__} on the "
                         f"device", "11")
    if name == "acceptance_rate":
        return (name, float(sch.target_rate))
    if name == "poly_decay_fixed_iter":
        return (name, float(sch.exponent))
    if name == "exp_decay_fixed_ratio":
        return (name, float(sch.alpha), float(sch.min_rate),
                float(sch.max_rate))
    if name == "daly":
        return (name, float(sch.alpha), float(sch.min_rate))
    if name == "ess":
        return (name, float(sch.target_relative_ess))
    return (name,)


def _initial_scheme(eps: "Temperature", max_np: int | None) -> tuple:
    init = eps.initial_temperature
    if isinstance(init, (int, float)):
        return ("constant", float(init))
    name = _SCHEME_NAMES.get(type(init).__name__)
    if name == "acceptance_rate":
        return (name, float(init.target_rate))
    if name is None or name == "ess":
        raise not_ported(f"initial temperature from "
                         f"{type(init).__name__} on the device", "11")
    # the other schemes read no data when there is no previous temperature
    try:
        temp = init(0, prev_temperature=None, max_nr_populations=max_np)
    except ValueError:
        temp = np.inf
    return ("constant", float(temp))


def device_config(eps, kernel, acceptor) -> TempConfig:
    """The K21b descriptor of a run, after the fused device path's
    capability rules (``pyabc_tpu`` ``ABCSMC._fused_stochastic_capable``):
    a max-found or ScaledPDFNorm norm without a log file; a ListTemperature
    ladder or a Temperature with min aggregation, monotone decay, no log
    file and device schemes only (the horizon set where a scheme needs
    it); a device-compatible noise kernel. Anything else raises: there
    is no host loop to fall back to. As the JAX package's ``_temp_config``,
    a SCALE_LIN kernel's ``pdf_max`` goes over as its log and ``lin``
    reaches K21a/K21c and K21b; a kernel without a (finite) maximum
    (NegativeBinomialKernel) leaves ``pdf_max`` None, and the norm is then
    the running maximum found."""
    from ..acceptor.pdf_norm import ScaledPDFNorm, pdf_norm_max_found
    from ..distance.kernel import SCALE_LIN

    meth = acceptor.pdf_norm_method
    if not (meth is pdf_norm_max_found or isinstance(meth, ScaledPDFNorm)):
        raise not_ported(f"pdf norm method {getattr(meth, '__name__', meth)}"
                         f" on the device (max-found and ScaledPDFNorm run "
                         f"there)", "11")
    if acceptor.log_file:
        raise not_ported("StochasticAcceptor(log_file=...)", "11")
    pdf_scaled = ((float(meth.factor), float(meth.alpha))
                  if isinstance(meth, ScaledPDFNorm) else None)
    max_np = getattr(eps, "_max_nr_populations", None)
    if type(eps) is ListTemperature:
        schemes, initial = (), ("constant", float(eps(0)))
    elif type(eps) is Temperature:
        if (eps.aggregate_fun is not min or not eps.enforce_less_equal_prev
                or eps.log_file):
            raise not_ported("a Temperature with another aggregate, "
                             "without monotone decay or with a log file",
                             "11")
        schemes = tuple(_scheme_tuple(s) for s in eps._effective_schemes())
        if not schemes:
            raise not_ported("a Temperature without schemes", "11")
        if max_np is None and any(s[0] in _NEED_HORIZON for s in schemes):
            raise not_ported("a fixed-horizon temperature scheme without "
                             "max_nr_populations", "11")
        initial = _initial_scheme(eps, max_np)
    else:
        raise not_ported(f"epsilon {type(eps).__name__} with a "
                         f"StochasticAcceptor", "11")
    lin = kernel.ret_scale == SCALE_LIN
    pdf_max = kernel.pdf_max
    if pdf_max is not None:
        pdf_max = (float(np.log(max(pdf_max, 1e-300))) if lin
                   else float(pdf_max))
        if not np.isfinite(pdf_max):
            pdf_max = None
    return TempConfig(schemes=schemes,
                      max_np=int(max_np) if max_np is not None else -1,
                      pdf_max=pdf_max, lin=lin, pdf_scaled=pdf_scaled,
                      initial=initial)
