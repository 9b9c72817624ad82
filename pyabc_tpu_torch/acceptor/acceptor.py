"""Acceptors (``pyabc_tpu/acceptor/acceptor.py`` counterpart).

The uniform acceptor's device form is the accept test of the K5 kernel
(``kernels/pnorm_accept.py``); the stochastic acceptor's is the K21a
kernel (``kernels/kernel_accept.py``), and its per-generation pdf-norm
recursion runs in the K21b kernel (``kernels/temperature_update.py``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from ..distance.kernel import SCALE_LIN, SCALE_LOG, StochasticKernel
from .pdf_norm import pdf_norm_max_found


class UniformAcceptor:
    """Accept iff distance <= epsilon. ``use_complete_history`` also
    requires the distance to be below every earlier threshold (the device
    carries the running minimum)."""

    def __init__(self, use_complete_history: bool = False):
        self.use_complete_history = bool(use_complete_history)
        #: the host loop's threshold trail (``note_epsilon``)
        self._eps_history: dict[int, float] = {}

    # the per-generation host loop's lifecycle (``pyabc_tpu/acceptor/
    # acceptor.py:44-53, :97-112``)
    def initialize(self, t, get_weighted_distances=None,
                   distance_function=None, x_0=None) -> None:
        pass

    def update(self, t, get_weighted_distances=None, prev_temp=None,
               acceptance_rate=None) -> None:
        pass

    def get_epsilon_config(self, t: int) -> dict:
        return {}

    def note_epsilon(self, t: int, eps_value: float,
                     distance_changed: bool) -> None:
        """Record the threshold used at generation t; after a distance
        change the earlier thresholds no longer compare, so the trail
        restarts."""
        if distance_changed:
            self._eps_history.clear()
        self._eps_history[t] = float(eps_value)

    def historic_min(self, t: int | None) -> float:
        """The smallest threshold before generation t (``use_complete_
        history``'s second test), +inf without one."""
        vals = [e for s, e in self._eps_history.items()
                if t is None or s < t]
        return min(vals) if vals else np.inf

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def __repr__(self):
        return (f"UniformAcceptor(use_complete_history="
                f"{self.use_complete_history})")


class StochasticAcceptor:
    """Exact-likelihood stochastic acceptor. Requires a ``StochasticKernel``
    distance and a temperature epsilon. At temperature T a particle with
    kernel value v (log scale) is accepted with probability min(1,
    exp((v - pdf_norm) / T)); above the norm the excess is its importance
    weight.

    On the device path the norm is a device tensor carried from one
    generation to the next; after each chunk's fetch the host mirrors it
    into ``pdf_norms`` and ``_max_found``. ``initialize``/``update`` are the
    host recursion the device one is tested against."""

    def __init__(self, pdf_norm_method: Callable = pdf_norm_max_found,
                 apply_importance_weighting: bool = True,
                 log_file: str | None = None):
        self.pdf_norm_method = pdf_norm_method
        self.apply_importance_weighting = bool(apply_importance_weighting)
        self.log_file = log_file
        #: per-generation normalization constants (log scale)
        self.pdf_norms: dict[int, float] = {}
        self._kernel: StochasticKernel | None = None
        self._max_found: float = -np.inf

    def initialize(self, t, get_weighted_distances=None,
                   distance_function=None, x_0=None):
        if not isinstance(distance_function, StochasticKernel):
            raise TypeError(
                "StochasticAcceptor requires a StochasticKernel distance")
        self._kernel = distance_function
        self._update_norm(t, get_weighted_distances)

    def update(self, t, get_weighted_distances=None, prev_temp=None,
               acceptance_rate=None):
        self._update_norm(t, get_weighted_distances)

    def _update_norm(self, t, get_weighted_distances):
        kernel_value = None
        if get_weighted_distances is not None:
            vals = np.asarray(get_weighted_distances()["distance"],
                              np.float64)
            if self._kernel.ret_scale == SCALE_LIN:
                vals = np.log(np.maximum(vals, 1e-300))
            if len(vals):
                self._max_found = max(self._max_found, float(np.max(vals)))
                kernel_value = vals
        pdf_max = self._kernel.pdf_max if self._kernel else None
        if pdf_max is not None and self._kernel.ret_scale == SCALE_LIN:
            pdf_max = np.log(max(pdf_max, 1e-300))
        self.pdf_norms[t] = float(self.pdf_norm_method(
            kernel_val=kernel_value, pdf_max=pdf_max,
            max_found=self._max_found,
            prev_pdf_norm=(max(self.pdf_norms.values()) if self.pdf_norms
                           else None)))

    def get_epsilon_config(self, t: int) -> dict:
        return {
            "pdf_norm": self.pdf_norms.get(t),
            "kernel_scale": (self._kernel.ret_scale if self._kernel
                             else SCALE_LOG),
        }

    def get_config(self) -> dict:
        return {"name": type(self).__name__,
                "pdf_norm_method": getattr(self.pdf_norm_method, "__name__",
                                           "?")}

    def __repr__(self):
        return (f"StochasticAcceptor(apply_importance_weighting="
                f"{self.apply_importance_weighting})")
