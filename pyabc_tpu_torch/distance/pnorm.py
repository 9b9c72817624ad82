"""Weighted p-norm distances, fixed and adaptive
(``pyabc_tpu/distance/pnorm.py`` counterpart).

d(x, x0) = (sum_i (w_i |x_i - x0_i|)^p)^(1/p); p = inf gives the max. The
round's distance, accept test and log-weight run in the K5 kernel
(``kernels/pnorm_accept.py``); the adaptive refit (the scale over the
record ring, 1/scale weights, then the reservoir's distances under the new
weights) is the K9 kernel (``kernels/scale_reduce.py``). ``device_bound_fn``
is the prefix bound that segmented early reject (K18,
``kernels/segment_round.py``) retires candidates on; under early reject an
adaptive refit finishes from the moment block of the resolved candidates
(K22, ``kernels/moments.py``) instead of the record ring.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels.moments import moment_finish
from ..kernels.pnorm_accept import pnorm_rows
from ..kernels.scale_reduce import scale_reduce
from ..kernels.segment_round import BOUND_RTOL, bound_fold, bound_limit
from ..ops.scale_reduce import SHARDED_SCALE_NAMES
from .scale import (builtin_scale_name, device_scale_fn,
                    median_absolute_deviation)


class PNormDistance:
    """Fixed-weight weighted p-norm. ``weights`` is a flat vector, a dict
    keyed by sum-stat label or name, or None (all ones)."""

    def __init__(self, p: float = 2.0, weights=None, sumstat=None):
        if p < 1:
            raise ValueError("p must be >= 1")
        if sumstat is not None:
            raise NotImplementedError(
                "learned summary statistics are not ported yet (ROADMAP "
                "queue A, item 14)")
        if isinstance(weights, dict) and weights and all(
                isinstance(k, (int, np.integer)) for k in weights):
            raise NotImplementedError(
                "per-generation weight schedules are not ported yet "
                "(ROADMAP queue A, item 12)")
        self.p = float(p)
        self._weights_arg = weights
        self.spec = None
        #: host mirror of the weights in effect per generation
        self.weights: dict[int, np.ndarray] = {}

    adaptive = False

    def requires_calibration(self) -> bool:
        return False

    def initialize(self, spec) -> None:
        self.spec = spec
        w = self._weights_arg
        if w is None:
            return
        if isinstance(w, dict):
            vec = np.ones(spec.total_size)
            labels = spec.labels()
            for k, v in w.items():
                if k in labels:
                    vec[labels.index(k)] = v
                elif k in spec.names:
                    off = spec.offsets[k]
                    vec[off: off + spec.sizes[k]] = v
                else:
                    raise KeyError(f"unknown sum-stat label {k!r}")
            self.weights[-1] = vec
        else:
            self.weights[-1] = np.ravel(np.asarray(w, np.float64))

    def initial_weights(self, device) -> torch.Tensor:
        """The (S,) float32 device weight vector the run starts with."""
        w = self.weights.get(-1)
        if w is None:
            w = np.ones(self.spec.total_size)
        return torch.as_tensor(np.asarray(w, np.float32), device=device)

    def rows(self, ss: torch.Tensor, x0: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
        """Plain distances of every row of ``ss`` under weights ``w``."""
        return pnorm_rows(ss, x0, w, self.p)

    #: relative slack of the early-reject comparison: the segmented
    #: round's prefix sum and K5's full sum round in different orders, so
    #: a bound within this band of the threshold never retires
    BOUND_RTOL = BOUND_RTOL

    def device_bound_fn(self, spec=None) -> dict:
        """The monotone lower bound over sum-stat prefixes that the
        segmented round (K18) folds: every term of the weighted p-norm is
        nonnegative, so the p-th-power partial sum (p = inf: the running
        max) of any prefix lower-bounds the full sum and never decreases.
        ``init(B)``, ``step(acc, vals, idx, x0, w)`` (``vals`` a segment's
        ``(B, k)`` block at flat columns ``idx``) and ``exceeds(acc,
        threshold)``, compared in the p-th-power domain with the slack
        ``BOUND_RTOL``; K18 computes the same in the same order. The weights
        are the generation's, the ones the accept test uses. Learned
        transforms have no such bound in the port (ROADMAP queue A, item
        14)."""
        p = self.p

        def init(B: int, device=None) -> torch.Tensor:
            return torch.zeros(B, dtype=torch.float32, device=device)

        def step(acc, vals, idx, x0, w):
            idx = torch.as_tensor(idx, dtype=torch.int64, device=acc.device)
            return bound_fold(acc, vals, x0[idx], w[idx], p)

        def exceeds(acc, threshold):
            return acc > bound_limit(torch.as_tensor(
                threshold, dtype=torch.float32, device=acc.device), p)

        return {"init": init, "step": step, "exceeds": exceeds}

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "p": self.p}

    def __repr__(self):
        return f"{type(self).__name__}(p={self.p})"


class AdaptivePNormDistance(PNormDistance):
    """Self-reweighting p-norm: each generation the weights are refit to
    1/scale over all recorded simulations (accepted and rejected),
    optionally clipped to ``max_weight_ratio`` and normalized to mean 1."""

    def __init__(self, p: float = 2.0,
                 scale_function: Callable = median_absolute_deviation,
                 adaptive: bool = True, normalize_weights: bool = True,
                 max_weight_ratio: float | None = None,
                 scale_log_file: str | None = None, sumstat=None):
        super().__init__(p=p, weights=None, sumstat=sumstat)
        if scale_log_file is not None:
            raise NotImplementedError(
                "scale_log_file is not ported yet (ROADMAP queue A, item 17)")
        if device_scale_fn(scale_function) is None:
            raise NotImplementedError(
                f"scale function {scale_function!r} has no device twin; "
                f"custom scale functions need the host samplers (ROADMAP "
                f"queue A, item 16)")
        self.scale_function = scale_function
        self.adaptive = bool(adaptive)
        self.normalize_weights = bool(normalize_weights)
        self.max_weight_ratio = max_weight_ratio

    def requires_calibration(self) -> bool:
        return True

    def _reduce(self, samples, valid, x0, rows=None):
        return scale_reduce(samples, valid, x0,
                            scale_name=self.scale_function.__name__,
                            max_weight_ratio=self.max_weight_ratio,
                            normalize_weights=self.normalize_weights,
                            rows=rows, p=self.p)

    def scale(self, samples: torch.Tensor, valid: torch.Tensor,
              x0: torch.Tensor) -> torch.Tensor:
        """Device (S,) scale over the rows of ``samples`` with ``valid``."""
        return self._reduce(samples, valid, x0)[0]

    def refit(self, samples: torch.Tensor, valid: torch.Tensor,
              x0: torch.Tensor, rows: torch.Tensor):
        """The generation step's refit in one K9 call: the scale over
        ``samples`` under ``valid``, the new weights, and the distances of
        ``rows`` under them -> (weights, distances)."""
        _scale, w, d = self._reduce(samples, valid, x0, rows)
        return w, d

    def sharded_scale_capable(self) -> bool:
        """True when the refit has a moment form (the seven names of
        ``SHARDED_SCALE_NAMES``, a built-in function): the condition for
        the refit over resolved candidates under early reject."""
        if not self.adaptive:
            return False
        return builtin_scale_name(self.scale_function) in SHARDED_SCALE_NAMES

    def refit_from_moments(self, mom: torch.Tensor, x0: torch.Tensor,
                           rows: torch.Tensor):
        """The generation step's refit under early reject in one K22
        finish: the scale from the ``(6, S)`` moment block, the new
        weights, and the distances of ``rows`` under them -> (weights,
        distances)."""
        _scale, w, d = moment_finish(
            mom, x0, scale_name=self.scale_function.__name__,
            max_weight_ratio=self.max_weight_ratio,
            normalize_weights=self.normalize_weights, rows=rows, p=self.p)
        return w, d

    def get_config(self) -> dict:
        return {"name": type(self).__name__, "p": self.p,
                "scale_function": self.scale_function.__name__}

    def __repr__(self):
        return (f"AdaptivePNormDistance(p={self.p}, "
                f"scale_function={self.scale_function.__name__})")
