"""Weighted p-norm distances, fixed and adaptive
(``pyabc_tpu/distance/pnorm.py`` counterpart).

d(x, x0) = (sum_i (w_i |x_i - x0_i|)^p)^(1/p); p = inf gives the max. The
weights may follow a per-generation schedule (``weights={t: ...}``): the
latest key <= t is in effect at generation t, resolved on the host into
the ``(S,)`` vector ``device_params(t)``. The round's distance, accept test
and log-weight run in the K5 kernel
(``kernels/pnorm_accept.py``); the adaptive refit (the scale over the
record ring, 1/scale weights, then the reservoir's distances under the new
weights) is the K9 kernel (``kernels/scale_reduce.py``). ``device_bound_fn``
is the prefix bound that segmented early reject (K18,
``kernels/segment_round.py``) retires candidates on; under early reject an
adaptive refit finishes from the moment block of the resolved candidates
(K22, ``kernels/moments.py``) instead of the record ring.

Learned statistics (``sumstat=PredictorSumstat(LinearPredictor(...))``):
the identity until the host seed fit after generation 0, then the fitted
linear transform; ``device_params`` is then ``{"w": (C',), "ss": the
transform}`` and the accept runs through K23 (``kernels/linear_sumstat.py``).
The adaptive variant refits its weights in the transformed space (K9 over
the transformed record ring). Under a plain p = 2 norm the prefix bound is
the transformed one of K18 (``kernels/linear_bound.py``). The host-refit
mode's statistics (Lasso, GP and model-selection predictors,
``IdentitySumstat``, ``fit_every``) take the same ``{"w", "ss"}`` form
once they transform; the weights are then ``_feature_dim()`` wide (C', or
S times the number of an ``IdentitySumstat``'s functions).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels.linear_bound import linear_bound
from ..kernels.moments import moment_finish
from ..kernels.pnorm_accept import pnorm_rows
from ..kernels.scale_reduce import scale_reduce
from ..kernels.segment_round import BOUND_RTOL, bound_fold, bound_limit
from ..ops.scale_reduce import SHARDED_SCALE_NAMES
from .scale import (builtin_scale_name, device_scale_fn,
                    median_absolute_deviation)


def is_schedule(weights) -> bool:
    """True for a per-generation schedule ``{t: vector or {label: w}}``."""
    return isinstance(weights, dict) and bool(weights) and all(
        isinstance(k, (int, np.integer)) for k in weights)


class PNormDistance:
    """Fixed-weight weighted p-norm. ``weights`` is a flat vector, a dict
    keyed by sum-stat label or name, a per-generation schedule ``{t: vector
    or {label: w}}`` or None (all ones); ``factors`` (a vector or a label
    dict) multiply the weights in effect."""

    def __init__(self, p: float = 2.0, weights=None, factors=None,
                 sumstat=None):
        if p < 1:
            raise ValueError("p must be >= 1")
        self.p = float(p)
        #: a learned summary-statistic transform applied to x and x0
        #: before the norm (``sumstat/``), or None
        self.sumstat = sumstat
        self._weights_arg = weights
        self._factors_arg = factors
        self.spec = None
        #: the weights in effect from each generation on (-1: the
        #: default); the adaptive variant mirrors each refit here
        self.weights: dict[int, np.ndarray] = {}

    adaptive = False
    #: a plain p-norm, not an aggregate of several (K5, not K25)
    aggregated = False

    def requires_calibration(self) -> bool:
        return False

    def initialize(self, spec) -> None:
        self.spec = spec
        w = self._weights_arg
        if w is None:
            return
        if is_schedule(w):
            for t, wt in w.items():
                self.weights[int(t)] = self._coerce_weight_vector(wt)
        else:
            self.weights[-1] = self._coerce_weight_vector(w)

    def _coerce_weight_vector(self, w) -> np.ndarray:
        """A flat vector, or a dict keyed by sum-stat label or name (the
        rest 1), as a float64 vector."""
        if not isinstance(w, dict):
            return np.ravel(np.asarray(w, np.float64))
        spec = self.spec
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
        return vec

    # ------------------------------------------- the host loop's lifecycle
    def configure_sampler(self, sampler) -> None:
        """A fixed p-norm needs no records."""

    def host_initialize(self, t: int, get_all_sum_stats=None,
                        x_0=None, device=None, sync_ledger=None) -> None:
        """The per-generation host loop's ``initialize`` (``pnorm.py:67``
        of the JAX package) after ``initialize(spec)``: nothing to fit
        (the run's ``device`` and ``sync_ledger`` play no part)."""

    def update(self, t: int, get_all_sum_stats=None,
               population=None) -> bool:
        """The host loop's update after generation t - 1 -> whether the
        distance changed (a fixed p-norm never does)."""
        return False

    def host_batch(self, ss_mat: np.ndarray, x0_flat: np.ndarray,
                   t: int | None = None) -> np.ndarray:
        """The distances of the rows of an ``(n, S)`` matrix under the
        weights of generation t, in float64 numpy."""
        ss_mat = np.asarray(ss_mat, np.float64)
        x0f = np.asarray(x0_flat, np.float64)
        w = self.weights_for(t)
        if w is None:
            w = np.ones_like(x0f)
        if self._factors_arg is not None:
            w = w * self._coerce_weight_vector(self._factors_arg)
        diff = w[None, :] * np.abs(ss_mat - x0f[None, :])
        if np.isinf(self.p):
            return np.max(diff, axis=1)
        return np.sum(diff ** self.p, axis=1) ** (1.0 / self.p)

    def weights_for(self, t: int | None) -> np.ndarray | None:
        """The weights in effect at generation t: the latest key in [0,
        t], else the default (-1), else None (all ones)."""
        if not self.weights:
            return None
        if t is not None:
            past = [s for s in self.weights if 0 <= s <= t]
            if past:
                return self.weights[max(past)]
        return self.weights.get(-1)

    def schedule(self) -> bool:
        """True when the user's weights change with the generation."""
        return any(k >= 0 for k in self.weights)

    def _feature_dim(self) -> int:
        S = self.spec.total_size
        return self.sumstat.out_dim(S) if self.sumstat is not None else S

    def fitted_transform(self) -> bool:
        """True once the summary statistic transforms the rows (a fitted
        predictor, an ``IdentitySumstat`` with functions): the weights then
        live in its feature space, ``_feature_dim()`` wide."""
        return self.sumstat is not None and self.sumstat.transforms

    def device_params(self, t: int | None = None, device=None):
        """The float32 weights of generation t (factors applied), as the
        JAX package's ``device_params(t)``: ``(S,)``, or under a fitted
        learned transform ``{"w": (C',), "ss": its parameters}`` (weights
        of another width than C' give way to ones, as the JAX package's
        host call does)."""
        if self.spec is None:
            raise RuntimeError("distance not initialized (no SumStatSpec)")
        dim = self._feature_dim()
        w = self.weights_for(t)
        if w is None or (self.fitted_transform() and w.shape != (dim,)):
            w = np.ones(dim)
        if self._factors_arg is not None:
            w = w * self._coerce_weight_vector(self._factors_arg)
        w = torch.as_tensor(np.asarray(w, np.float32), device=device)
        if not self.fitted_transform():
            return w
        return {"w": w, "ss": self.sumstat.device_params(device)}

    def initial_weights(self, device) -> torch.Tensor:
        """The device weights the run starts with (generation 0's)."""
        return self.device_params(0, device)

    def host_weights(self, params) -> np.ndarray:
        """The host mirror of fetched device weights."""
        return np.asarray(params, np.float64)

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
        are the generation's, the ones the accept test uses.

        A learned transform mixes the columns, so the partial p-sum is no
        bound; for a linear plan under a plain p = 2 norm the transformed
        bound is (``_transformed_bound_fn``), else None."""
        if self.sumstat is not None:
            return self._transformed_bound_fn()
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

    def _transformed_bound_fn(self) -> dict | None:
        """The projector bound of a linear learned transform at p = 2
        (``pyabc_tpu/distance/pnorm.py:279-303``): ``{"linear": True,
        "prepare": K18's per-generation operands}``, or None (an adaptive
        distance, another p, another predictor). The JAX package also
        waits for the fit; the port decides before generation 0 and folds
        the bound from generation 1, once the seed fit has run."""
        from ..predictor import LinearPredictor
        from ..sumstat import PredictorSumstat

        if type(self) is not PNormDistance or self.p != 2.0:
            return None
        ss = self.sumstat
        if not isinstance(ss, PredictorSumstat) or not isinstance(
                ss.predictor, LinearPredictor):
            return None
        return {"linear": True, "prepare": linear_bound}

    def _sumstat_config(self) -> dict | None:
        """The learned-transform stack as the JAX package's config names
        it: predictor type, scalar hyperparameters, the fitted C'."""
        ss = self.sumstat
        if ss is None:
            return None
        cfg = {"name": type(ss).__name__}
        pred = getattr(ss, "predictor", None)
        if pred is not None:
            pcfg = {"name": type(pred).__name__}
            for attr in ("alpha", "lr", "n_steps", "hidden", "n_iter"):
                val = getattr(pred, attr, None)
                if isinstance(val, (int, float)):
                    pcfg[attr] = val
                elif isinstance(val, (tuple, list)):
                    pcfg[attr] = tuple(val)
            pcfg["fitted"] = bool(pred.fitted)
            cfg["predictor"] = pcfg
        if getattr(ss, "_out_dim", None) is not None:
            cfg["out_dim"] = int(ss._out_dim)
        if getattr(ss, "fit_every", None) is not None:
            cfg["fit_every"] = int(ss.fit_every)
        return cfg

    def get_config(self) -> dict:
        cfg = {"name": type(self).__name__, "p": self.p}
        if self.sumstat is not None:
            cfg["sumstat"] = self._sumstat_config()
        return cfg

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
        #: the observed row (float64) the host loop's scale functions read
        self._x_0: np.ndarray | None = None

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
              x0: torch.Tensor, rows: torch.Tensor, params=None):
        """The generation step's refit in one K9 call: the scale over
        ``samples`` under ``valid``, the new weights, and the distances of
        ``rows`` under them -> (weights, distances). The weights in effect
        (``params``) play no part."""
        _scale, w, d = self._reduce(samples, valid, x0, rows)
        return w, d

    def configure_sampler(self, sampler) -> None:
        """The refit reads every evaluation: the sampler records them."""
        if self.adaptive:
            sampler.sample_factory.record_rejected = True

    def host_initialize(self, t: int, get_all_sum_stats=None,
                        x_0=None, device=None, sync_ledger=None) -> None:
        """The host loop's ``initialize`` (``pnorm.py:381``): the weights
        of generation t fitted on the calibration sample (a ring left on
        the card is reduced there; ``device`` and ``sync_ledger`` play no
        part)."""
        self._x_0 = None if x_0 is None else np.asarray(x_0, np.float64)
        if get_all_sum_stats is not None:
            self._fit(t, get_all_sum_stats())

    def update(self, t: int, get_all_sum_stats=None,
               population=None) -> bool:
        """The host loop's refit of the weights of generation t over
        generation t - 1's records (``pnorm.py:388``)."""
        if not self.adaptive or get_all_sum_stats is None:
            return False
        self._fit(t, get_all_sum_stats())
        return True

    def _fit(self, t: int, samples) -> None:
        """``weights[t]`` = 1/scale over the records, the largest ratio
        clipped and the mean normalized to 1 (``pnorm.py:552-577``). A ring
        left on the card is reduced there (K9): the generation's own scale
        where it came with the collect, else one K9 launch and a read of
        the ``(S,)`` scale; a host matrix takes the numpy scale function."""
        from ..observability.sync import to_host
        from ..sampler.base import DeviceRecords

        if isinstance(samples, DeviceRecords) and samples.scale is not None:
            scale = np.asarray(samples.scale, np.float64)
        elif isinstance(samples, DeviceRecords):
            dev = samples.sumstats_dev.device
            x0 = torch.as_tensor(self._x_0, dtype=torch.float32).to(dev)
            scale = to_host({"scale": self.scale(
                samples.sumstats_dev, samples.valid_dev, x0)},
                samples.sync_ledger, "scale_fetch")["scale"].astype(
                    np.float64)
        else:
            samples = np.asarray(samples, np.float64)
            try:
                scale = self.scale_function(samples, self._x_0)
            except TypeError:
                scale = self.scale_function(samples)
            scale = np.asarray(scale, np.float64)
        w = np.zeros_like(scale)
        pos = scale > 0
        w[pos] = 1.0 / scale[pos]
        if self.max_weight_ratio is not None and pos.any():
            w = np.minimum(w, w[pos].min() * self.max_weight_ratio)
        if self.normalize_weights and w.sum() > 0:
            w = w * (w.size / w.sum())
        self.weights[int(t)] = w

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

    def refit_sharded(self, mom: torch.Tensor, x0: torch.Tensor,
                      feat: torch.Tensor, params=None):
        """The sharded generation step's refit in one K24d finish
        (``pyabc_tpu`` ``device_sharded_reduce`` and the ``combine`` of
        ``device_sharded_dfeat``, ``pnorm.py:447-491``): the ``(n, 6, S)``
        shard blocks combined in shard order, the scale, the new weights,
        and the distances of the reservoir's feature rows ``feat`` (``|x -
        x0|^p``, K24a's at accept time) under them as ``(sum w^p
        f)^(1/p)``, the JAX package's declared floating-point form ->
        (weights, distances). The weights in effect (``params``) play no
        part."""
        _scale, w, d = moment_finish.shards(
            mom, x0, feat, scale_name=builtin_scale_name(self.scale_function),
            max_weight_ratio=self.max_weight_ratio,
            normalize_weights=self.normalize_weights, p=self.p)
        return w, d

    def get_config(self) -> dict:
        return {**super().get_config(),
                "scale_function": self.scale_function.__name__}

    def __repr__(self):
        return (f"AdaptivePNormDistance(p={self.p}, "
                f"scale_function={self.scale_function.__name__})")
