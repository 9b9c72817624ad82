"""Aggregated distances (``pyabc_tpu/distance/aggregate.py`` counterpart).

d(x, x0) = sum_k W_k d_k(x, x0): a weighted sum of plain p-norm
sub-distances, each with its own weights (and schedule) and p. The top-level
weights ``W`` (times ``factors``) may follow a per-generation schedule
``{t: vector}``. On the device the distance is one flat float32 tensor
``[W (n), w_1 (S), ..., w_n (S)]`` (``device_params(t)``); the round's
distance, accept test and log weight run in K25's accept kernel, the
segmented round's prefix bound in K18's aggregate mode.

``AdaptiveAggregatedDistance`` refits W each generation, and from the
calibration sample, to ``factors / scale`` of each sub-distance's values
over the record ring (the default scale is the span, max - min), in one K25
refit: the sub-distances of the ring's rows, their column scale, the new W
and the reservoir's distances under it. The host ``weights`` dict mirrors
each refit (without the factors), as the JAX package's does.

Served as in the JAX package's fused path: plain ``PNormDistance``
sub-distances, at most ``MAX_SUB`` of them; an adaptive aggregate with a
built-in one-argument scale and no sub-distance schedule.

Sharded sampling (``ABCSMC(..., sharded=n)``): a fixed or scheduled
aggregate runs as unsharded; an adaptive one whose scale has a moment form
(``sharded_scale_capable``: span, mean or standard deviation) folds each
shard's value columns, the ``n`` sub-distances of every ring-eligible
evaluation, into a ``(6, n)`` moment block (K24d's fold over K25's value
rows), stores each accepted row's value row (K24a's given-rows mode) and
refits from the combined blocks (``refit_sharded``: K25's sharded finish).
Its first weights come from the calibration's prior sample through K25's
refit (``host_initialize``). The distances of
the JAX package's ``DistanceWithMeasureList`` family (``ZScoreDistance``,
``PCADistance``, ``RangeEstimatorDistance``, ``MinMaxDistance``,
``PercentileDistance``) run on its host loop only and are not ported.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels.aggregate import MAX_SUB, aggregate_finish, aggregate_refit
from ..kernels.segment_round import BOUND_RTOL, agg_total, bound_fold
from ..ops.scale_reduce import SHARDED_SCALE_NAMES
from ..utils import not_ported
from .pnorm import PNormDistance, is_schedule
from .scale import builtin_scale_name


class AggregatedDistance:
    """Weighted sum of plain p-norm sub-distances; ``weights`` None (all
    ones), a vector or a schedule ``{t: vector}``; ``factors`` multiply
    them."""

    adaptive = False
    #: a weighted sum of sub-distances (K25, not K5)
    aggregated = True

    def __init__(self, distances: Sequence, weights=None, factors=None):
        self.distances = list(distances)
        for d in self.distances:
            if type(d) is not PNormDistance:
                raise not_ported(
                    f"a {type(d).__name__} sub-distance of an aggregated "
                    f"distance (the fused path serves plain PNormDistance "
                    f"sub-distances)", "12")
            if d.sumstat is not None:
                # the JAX package's fused gate refuses it too
                raise not_ported("a sub-distance with a learned sumstat of "
                                 "an aggregated distance (the JAX "
                                 "package's host loop only)", "14")
        n = len(self.distances)
        if not 0 < n <= MAX_SUB:
            raise not_ported(f"an aggregated distance of {n} sub-distances "
                             f"(K25 takes 1 to {MAX_SUB})", "12")
        if weights is None:
            self.weights = {-1: np.ones(n)}
        elif isinstance(weights, dict):
            self.weights = {int(t): np.asarray(w, np.float64)
                            for t, w in weights.items()}
        else:
            self.weights = {-1: np.asarray(weights, np.float64)}
        self.factors = (np.ones(n) if factors is None
                        else np.asarray(factors, np.float64))
        self.spec = None

    @property
    def ps(self) -> tuple:
        """The sub-distances' p's, in order."""
        return tuple(d.p for d in self.distances)

    def requires_calibration(self) -> bool:
        return False

    def initialize(self, spec) -> None:
        self.spec = spec
        for d in self.distances:
            d.initialize(spec)

    def _feature_dim(self) -> int:
        """The width of a row's distance features in a sharded run: its
        ``n`` sub-distances (a p-norm's is S)."""
        return len(self.distances)

    def host_initialize(self, t: int, get_all_sum_stats=None,
                        x_0=None, device=None, sync_ledger=None) -> None:
        """``initialize`` at t of the host calibration (``aggregate.py:43``
        of the JAX package): the plain sub-distances fit nothing."""

    def host_batch(self, ss_mat: np.ndarray, x0_flat: np.ndarray,
                   t: int | None = None) -> np.ndarray:
        """The distances of the rows of an ``(n, S)`` matrix under the
        weights of generation t, in float64 numpy (the JAX package's
        ``__call__``)."""
        W = self._weights_for(t) * self.factors
        vals = np.stack([d.host_batch(ss_mat, x0_flat, t)
                         for d in self.distances], 1)
        return vals @ np.asarray(W, np.float64)

    def _weights_for(self, t: int | None) -> np.ndarray:
        """The top-level weights in effect at generation t (latest key in
        [0, t], else the default)."""
        if t is not None:
            past = [s for s in self.weights if 0 <= s <= t]
            if past:
                return self.weights[max(past)]
        return self.weights.get(-1, np.ones(len(self.distances)))

    def schedule(self) -> bool:
        """True when the top-level or a sub-distance's weights change with
        the generation (the JAX package's ``_weight_schedule_fused``)."""
        return (any(k >= 0 for k in self.weights)
                or any(d.schedule() for d in self.distances))

    def device_params(self, t: int | None = None,
                      device=None) -> torch.Tensor:
        """``[W (n), w_1 (S), ..., w_n (S)]`` of generation t, float32:
        the JAX package's ``device_params(t)`` flattened."""
        W = np.asarray(self._weights_for(t) * self.factors, np.float32)
        subs = [d.device_params(t).numpy() for d in self.distances]
        return torch.as_tensor(np.concatenate([W, *subs]), device=device)

    def initial_weights(self, device) -> torch.Tensor:
        """The device params the run starts with (generation 0's)."""
        return self.device_params(0, device)

    def host_weights(self, params) -> np.ndarray:
        """The host mirror of fetched device params: W without the factors
        (0 where a factor is 0), as the JAX package's
        ``_device_w_to_host``."""
        f = self.factors
        comb = np.asarray(params, np.float64)[:len(self.distances)]
        return np.where(f != 0, comb / np.where(f != 0, f, 1.0), 0.0)

    def device_bound_fn(self, spec=None) -> dict:
        """The monotone lower bound K18's aggregate mode folds: each
        sub-distance its own p-th-power prefix sum (p = inf: the running
        max), ``acc (B, n)``; a slot exceeds the threshold once
        ``sum_k W_k acc_k^(1/p_k)`` passes ``thr (1 + BOUND_RTOL)``, sound
        while every weight and factor is nonnegative (the early-reject gate
        checks). ``init(B)``, ``step(acc, vals, idx, x0, params)`` and
        ``exceeds(acc, threshold, params)``."""
        ps = self.ps
        n = len(ps)

        def init(B: int, device=None) -> torch.Tensor:
            return torch.zeros(B, n, dtype=torch.float32, device=device)

        def step(acc, vals, idx, x0, params):
            idx = torch.as_tensor(idx, dtype=torch.int64, device=acc.device)
            subw = params[n:].reshape(n, x0.shape[0])
            return torch.stack([bound_fold(acc[:, k], vals, x0[idx],
                                           subw[k][idx], p)
                                for k, p in enumerate(ps)], 1)

        def exceeds(acc, threshold, params):
            thr = torch.as_tensor(threshold, dtype=torch.float32,
                                  device=acc.device)
            return agg_total(acc, params[:n], ps) > thr * (1.0 + BOUND_RTOL)

        return {"init": init, "step": step, "exceeds": exceeds}

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def __repr__(self):
        return f"{type(self).__name__}({self.distances!r})"


def _span_of_values(values: np.ndarray) -> float:
    return float(np.max(values) - np.min(values))


#: scales that need the observation: a column of sub-distances has none
_TWO_ARG_SCALES = frozenset({
    "bias", "root_mean_square_deviation",
    "median_absolute_deviation_to_observation",
    "mean_absolute_deviation_to_observation",
    "combined_median_absolute_deviation",
    "combined_mean_absolute_deviation",
    "standard_deviation_to_observation",
})


class AdaptiveAggregatedDistance(AggregatedDistance):
    """Aggregated distance whose top-level weights are refit each
    generation to ``1 / scale`` of each sub-distance's values over every
    recorded simulation (accepted and rejected), so all sub-distances
    contribute comparably."""

    def __init__(self, distances: Sequence,
                 scale_function: Callable | None = None,
                 adaptive: bool = True, log_file: str | None = None):
        super().__init__(distances)
        if log_file is not None:
            raise not_ported("log_file of AdaptiveAggregatedDistance", "17")
        if not adaptive:
            raise not_ported(
                "AdaptiveAggregatedDistance with adaptive=False (the JAX "
                "package serves it on its host loop)", "16")
        self.scale_function = scale_function or _span_of_values
        if self.device_scale_impl() is None:
            raise not_ported(
                f"scale function {self.scale_function!r} of "
                f"AdaptiveAggregatedDistance (a custom or two-argument "
                f"scale takes the JAX package's host loop)", "16")
        if any(is_schedule(d._weights_arg) for d in self.distances):
            raise not_ported(
                "a per-generation sub-distance schedule under "
                "AdaptiveAggregatedDistance (the JAX package serves it on "
                "its host loop)", "16")
        self.adaptive = True

    def requires_calibration(self) -> bool:
        return True

    def host_initialize(self, t: int, get_all_sum_stats=None,
                        x_0=None, device=None, sync_ledger=None) -> None:
        """The weights of generation t fitted on the calibration sample
        (``aggregate.py:160-196`` of the JAX package) through one K25
        refit on ``device`` (the run's): ``W = factors / scale`` of the
        sub-distances' values over the sample's rows (sent there in one
        copy), read back in one ``scale_fetch`` recorded in
        ``sync_ledger``. The host mirror keeps W without the factors."""
        from ..observability.sync import SyncLedger, to_host

        if get_all_sum_stats is None:
            return
        ring = torch.as_tensor(np.asarray(get_all_sum_stats(), np.float32),
                               device=device)
        valid = torch.ones(ring.shape[0], dtype=torch.bool,
                           device=ring.device)
        x0 = torch.as_tensor(np.asarray(x_0, np.float32), device=ring.device)
        params, _d = self.refit(ring, valid, x0, None,
                                self.device_params(t, ring.device))
        new = to_host({"w": params[:len(self.distances)]},
                      sync_ledger if sync_ledger is not None
                      else SyncLedger(), "scale_fetch")["w"]
        self.weights[int(t)] = self.host_weights(new)

    def device_scale_impl(self) -> str | None:
        """The name of the built-in one-argument scale K25's refit runs, or
        None where only the JAX package's host loop can run it (a custom
        function, one shadowing a built-in name, or one that needs the
        observation)."""
        if self.scale_function is _span_of_values:
            return "span"
        name = builtin_scale_name(self.scale_function)
        return None if name in _TWO_ARG_SCALES else name

    def _subs_device_constant(self) -> bool:
        """True when every sub-distance is a plain, generation-constant
        ``PNormDistance`` (``aggregate.py:231-241`` of the JAX package):
        the sharded refit copies the sub weights of the params in
        effect."""
        return all(type(d) is PNormDistance and d.sumstat is None
                   and not is_schedule(d._weights_arg)
                   for d in self.distances)

    def sharded_scale_capable(self) -> bool:
        """The JAX package's gate (``aggregate.py:287``): adaptive, the
        sub-distances constant, and a built-in one-argument scale with a
        moment form (span, mean, standard deviation). Under early reject an
        aggregate still reads whole rows, which that gate refuses."""
        return (self.adaptive and self._subs_device_constant()
                and self.device_scale_impl() in SHARDED_SCALE_NAMES)

    def refit(self, samples: torch.Tensor, valid: torch.Tensor,
              x0: torch.Tensor, rows: torch.Tensor, params: torch.Tensor):
        """One K25 refit: the sub-distances of ``samples`` under the sub
        weights of ``params``, their scale over ``valid``, the new params
        and the distances of ``rows`` under them -> (params, distances)."""
        _scale, new, d = aggregate_refit(
            samples, valid, x0, params, ps=self.ps,
            factors=tuple(float(f) for f in self.factors),
            scale_name=self.device_scale_impl(), rows=rows)
        return new, d

    def refit_sharded(self, mom: torch.Tensor, x0: torch.Tensor,
                      feat: torch.Tensor, params: torch.Tensor):
        """The sharded generation step's refit in one K25 sharded finish
        (the JAX package's ``device_sharded_reduce``, ``device_weight_update``
        and ``device_sharded_dfeat``'s ``combine``, ``aggregate.py:298-362``,
        as ``util.py:2670-2700`` runs them): the ``(n, 6, n_sub)`` shard
        blocks of the value columns combined in shard order, the scale
        against a zero observation (``x0`` plays no part), ``W = factors /
        scale``, the sub weights of ``params`` (the params in effect)
        kept, and the distances of the reservoir's value rows ``feat``
        (K24a's) under the new W -> (params, distances)."""
        _scale, new, d = aggregate_finish.shards(
            mom, feat, params, factors=tuple(float(f) for f in self.factors),
            scale_name=self.device_scale_impl())
        return new, d

    def __repr__(self):
        return (f"AdaptiveAggregatedDistance({self.distances!r}, "
                f"scale_function={self.device_scale_impl()})")
