"""K25: the aggregated distance of a proposal round and its adaptive refit.

Counterpart of ``pyabc_tpu/distance/aggregate.py::AggregatedDistance.
device_fn`` (with ``UniformAcceptor.device_fn`` and the log weight, as K5),
``AdaptiveAggregatedDistance.device_record_reduce`` and
``device_weight_update`` and the recompute of the accepted rows' distances
under the new weights (``pyabc_tpu/inference/util.py:1847``); the CUDA
kernels are ``csrc/aggregate.cu``.

The distance's parameters are one flat float32 tensor ``[W (n), w_1 (S),
..., w_n (S)]``: the top-level weights times the factors, then each plain
p-norm sub-distance's weights. ``d = sum_k W_k d_k`` with ``d_k`` the k-th
weighted p-norm, summed in the order k = 0..n-1; n is at most ``MAX_SUB``.

Three wrappers:

- ``aggregate_accept_weight``: K5's accept test and log weight on the
  aggregated distance (K5's nullable K > 1 model terms too); its values
  mode (``.values``, counted in ``mode_launches``) returns the ``(B, n)``
  sub-distances, and its value-rows mode (``.value_rows``) both in one
  launch: the accept's outputs and the sub-distances it summed, bit for
  bit (sharded sampling under an adaptive aggregate folds and stores
  them, ``device_sharded_reduce``'s ``cols`` and ``device_sharded_dfeat``'s
  ``row``, ``pyabc_tpu/distance/aggregate.py:315-321, 340-343``);
- ``aggregate_refit``: the sub-distances of the record ring's rows, their
  column scale over the valid rows against a zero observation (span, the
  default, or another one-argument scale), ``W = factors / scale`` where
  ``scale > 0`` (else 0; no clip, no normalization) and the rows'
  aggregated distances under the new params;
- ``aggregate_finish.shards``: the sharded refit (counted in
  ``mode_launches["shards"]``): the shards' ``(n, 6, n_sub)`` moment blocks
  of the value columns combined in shard order, the scale against a zero
  observation (``scale_from_moments``), ``W = factors / scale`` as above,
  the sub weights of the params in effect copied, and each reservoir
  row's distance ``sum_k W_k f_k`` from its stored value row f, summed as
  the accept sums (``device_weight_update`` and ``device_sharded_dfeat``'s
  ``combine``, ``aggregate.py:345-362``). The JAX package's ``jnp.sum(wf
  * feat)`` may add in another order: a declared difference within
  rel 1e-6.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ..ops.scale_reduce import (MOMENT_ROWS, combine_moments,
                                 scale_from_moments)
from .base import Kernel
from .moments import SCALE_NAMES as MOMENT_SCALES
from .pnorm_accept import accept_epilogue_plain, expect_terms, pnorm_rows
from .scale_reduce import SCALE_NAMES, SCALES_PLAIN
from .select import workspace

#: sub-distances a launch takes (registers of a warp's lanes)
MAX_SUB = 8
#: the one-argument scales the refit takes (a column of sub-distances
#: has no observation of its own)
REFIT_SCALES = ("span", "median_absolute_deviation",
                "mean_absolute_deviation", "standard_deviation", "mean",
                "median")


def p_code(p: float) -> int:
    """The kernels' code of a sub-distance's p: 1, 2, inf or another."""
    return {1.0: 0, 2.0: 1, math.inf: 2}.get(float(p), 3)


def p_codes(ps) -> tuple:
    """(codes, ps) as C arrays for an entry point; (None, None) for none."""
    if not ps:
        return None, None
    n = len(ps)
    return ((ctypes.c_int * n)(*[p_code(p) for p in ps]),
            (ctypes.c_float * n)(*[float(p) for p in ps]))


# ------------------------------------------------------------ plain versions
def sub_distances_plain(ss: torch.Tensor, x0: torch.Tensor,
                        params: torch.Tensor, ps) -> torch.Tensor:
    """The ``(B, n)`` sub-distances of every row of ``ss``."""
    subw = params[len(ps):].reshape(len(ps), ss.shape[-1])
    return torch.stack([pnorm_rows(ss, x0, subw[k], p)
                        for k, p in enumerate(ps)], -1)


def combine_plain(W: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``sum_k W_k vals[:, k]`` in the order k = 0..n-1."""
    tot = torch.zeros_like(vals[..., 0])
    for k in range(vals.shape[-1]):
        tot = tot + W[k] * vals[..., k]
    return tot


def aggregate_rows_plain(ss, x0, params, ps) -> torch.Tensor:
    """Aggregated distances of every row of ``ss`` under ``params``."""
    return combine_plain(params[:len(ps)],
                         sub_distances_plain(ss, x0, params, ps))


def aggregate_accept_weight_plain(ss, x0, params, eps, valid, *, ps,
                                  hist_min=None, logpri=None, logq=None,
                                  log_offset: float = 0.0, m=None,
                                  model_logits=None, log_model_factor=None):
    """Plain PyTorch version -> (distance, accept, log_weight)."""
    return accept_epilogue_plain(
        aggregate_rows_plain(ss, x0, params, ps), eps, valid,
        hist_min=hist_min, logpri=logpri, logq=logq, log_offset=log_offset,
        m=m, model_logits=model_logits, log_model_factor=log_model_factor)


def weight_update_plain(scale: torch.Tensor, factors) -> torch.Tensor:
    """``device_weight_update``: ``factors / max(scale, 1e-38)`` where
    ``scale > 0``, else 0 (``factors`` a host sequence)."""
    inv = 1.0 / scale.clamp_min(1e-38)
    f = torch.tensor([float(x) for x in factors], dtype=torch.float32,
                     device=scale.device)
    return torch.where(scale > 0, inv, torch.zeros_like(scale)) * f


def aggregate_refit_plain(ring, valid, x0, params, *, ps, factors,
                          scale_name: str, rows=None):
    """Plain PyTorch version -> (scale (n,), the new params, the rows'
    distances under them or None); ``factors`` the top-level factors, a
    host sequence."""
    vals = sub_distances_plain(ring, x0, params, ps)
    zero = torch.zeros(len(ps), dtype=torch.float32, device=ring.device)
    scale = SCALES_PLAIN[scale_name](vals, valid, zero)
    W = weight_update_plain(scale, factors)
    new = torch.cat([W, params[len(ps):]])
    d = None if rows is None else aggregate_rows_plain(rows, x0, new, ps)
    return scale, new, d


def aggregate_finish_shards_plain(mom, feat, params, *, factors,
                                  scale_name: str):
    """Plain PyTorch version of the sharded finish -> (scale (n,), the new
    params, the rows' distances)."""
    n_sub = mom.shape[-1]
    zero = torch.zeros(n_sub, dtype=torch.float32, device=mom.device)
    scale = scale_from_moments(scale_name)(combine_moments(mom), zero)
    W = weight_update_plain(scale, factors)
    return scale, torch.cat([W, params[n_sub:]]), combine_plain(W, feat)


# --------------------------------------------------------------- wrappers
def _check_ps(kernel: Kernel, ps, S: int, params: torch.Tensor) -> int:
    n_sub = len(ps)
    if not 0 < n_sub <= MAX_SUB:
        raise ValueError(f"{kernel.name}: {n_sub} sub-distances (1 to "
                         f"{MAX_SUB})")
    kernel.expect(params, "params", torch.float32, (n_sub * (S + 1),))
    return n_sub


class AggregateAcceptWeight(Kernel):
    name = "aggregate_accept_weight"
    source = "pyabc_tpu_torch/csrc/aggregate.cu"
    replaces = "pyabc_tpu/distance/aggregate.py:73"

    def __init__(self):
        super().__init__()
        #: launches of the values mode alone and of the value-rows mode
        self.mode_launches = {"values": 0, "value_rows": 0}

    def __call__(self, ss, x0, params, eps, valid, *, ps, hist_min=None,
                 logpri=None, logq=None, log_offset: float = 0.0, m=None,
                 model_logits=None, log_model_factor=None):
        return self._accept(ss, x0, params, eps, valid, ps, False,
                            hist_min=hist_min, logpri=logpri, logq=logq,
                            log_offset=log_offset, m=m,
                            model_logits=model_logits,
                            log_model_factor=log_model_factor)

    def value_rows(self, ss, x0, params, eps, valid, *, ps, **terms):
        """The value-rows mode: the accept's (distance, accept, log weight)
        and the ``(B, n)`` sub-distances it summed, written by the same
        launch; ``terms`` as the accept's."""
        return self._accept(ss, x0, params, eps, valid, ps, True, **terms)

    def _accept(self, ss, x0, params, eps, valid, ps, with_vals: bool, *,
                hist_min=None, logpri=None, logq=None,
                log_offset: float = 0.0, m=None, model_logits=None,
                log_model_factor=None):
        models = (m, model_logits, log_model_factor)
        opt = [t for t in (hist_min, logpri, logq, *models)
               if t is not None]
        if self.on_cpu(ss, x0, params, eps, valid, *opt):
            vals = sub_distances_plain(ss, x0, params, ps)
            out = accept_epilogue_plain(
                combine_plain(params[:len(ps)], vals), eps, valid,
                hist_min=hist_min, logpri=logpri, logq=logq,
                log_offset=log_offset, m=m, model_logits=model_logits,
                log_model_factor=log_model_factor)
            return (*out, vals) if with_vals else out
        B, S = ss.shape
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        n_sub = _check_ps(self, ps, S, params)
        expect_terms(self, B, eps, valid, hist_min, logpri, logq, *models)
        dev = ss.device
        d = torch.empty(B, dtype=f32, device=dev)
        accept = torch.empty(B, dtype=torch.bool, device=dev)
        lw = torch.empty(B, dtype=f32, device=dev)
        vals = (torch.empty(B, n_sub, dtype=f32, device=dev) if with_vals
                else None)
        err = _build.library().pyabc_aggregate_accept(
            ss.data_ptr(), B, S, x0.data_ptr(), params.data_ptr(), n_sub,
            *p_codes(ps), valid.data_ptr(), eps.data_ptr(),
            self.ptr(hist_min), self.ptr(logpri), self.ptr(logq),
            float(log_offset), *(self.ptr(t) for t in models), d.data_ptr(),
            accept.data_ptr(), lw.data_ptr(), self.ptr(vals),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        if not with_vals:
            return d, accept, lw
        self.mode_launches["value_rows"] += 1
        return d, accept, lw, vals

    def values(self, ss, x0, params, *, ps) -> torch.Tensor:
        """The values mode: the ``(B, n)`` sub-distances of every row."""
        if self.on_cpu(ss, x0, params):
            return sub_distances_plain(ss, x0, params, ps)
        B, S = ss.shape
        f32 = torch.float32
        self.expect(ss, "ss", f32, (B, S))
        self.expect(x0, "x0", f32, (S,))
        n_sub = _check_ps(self, ps, S, params)
        vals = torch.empty(B, n_sub, dtype=f32, device=ss.device)
        err = _build.library().pyabc_aggregate_accept(
            ss.data_ptr(), B, S, x0.data_ptr(), params.data_ptr(), n_sub,
            *p_codes(ps), None, None, None, None, None, 0.0, None, None,
            None, None, None, None, vals.data_ptr(),
            _build.stream_ptr(ss.device))
        _build.check(err, f"{self.name}:values")
        self.launches += 1
        self.mode_launches["values"] += 1
        return vals


class AggregateRefit(Kernel):
    name = "aggregate_refit"
    source = "pyabc_tpu_torch/csrc/aggregate.cu"
    replaces = "pyabc_tpu/distance/aggregate.py:244"

    def __call__(self, ring, valid, x0, params, *, ps, factors,
                 scale_name: str, rows=None):
        extra = [] if rows is None else [rows]
        if self.on_cpu(ring, valid, x0, params, *extra):
            return aggregate_refit_plain(ring, valid, x0, params, ps=ps,
                                         factors=factors,
                                         scale_name=scale_name, rows=rows)
        if scale_name not in REFIT_SCALES:
            raise NotImplementedError(
                f"{self.name}: no kernel for the scale {scale_name!r} of "
                f"the sub-distance columns")
        n, S = ring.shape
        f32 = torch.float32
        self.expect(ring, "ring", f32, (n, S))
        self.expect(valid, "valid", torch.bool, (n,))
        self.expect(x0, "x0", f32, (S,))
        n_sub = _check_ps(self, ps, S, params)
        if len(factors) != n_sub:
            raise ValueError(f"{self.name}: {len(factors)} factors for "
                             f"{n_sub} sub-distances")
        n_rows = 0
        if rows is not None:
            n_rows = rows.shape[0]
            self.expect(rows, "rows", f32, (n_rows, S))
        dev = ring.device
        code = (-1 if scale_name == "span"
                else SCALE_NAMES.index(scale_name))
        vals = torch.empty(n, n_sub, dtype=f32, device=dev)
        zeros = torch.zeros(n_sub, dtype=f32, device=dev)
        ws = workspace(n_sub, 2, False, dev)
        stats = torch.empty(8 * n_sub, dtype=f32, device=dev)
        w_scratch = torch.empty(n_sub, dtype=f32, device=dev)
        scale = torch.empty(n_sub, dtype=f32, device=dev)
        new = torch.empty_like(params)
        d = (torch.empty(n_rows, dtype=f32, device=dev) if rows is not None
             else None)
        # the factors travel by value, as the p's do
        fac = (ctypes.c_float * n_sub)(*[float(x) for x in factors])
        err = _build.library().pyabc_aggregate_refit(
            ring.data_ptr(), n, S, valid.data_ptr(), x0.data_ptr(),
            params.data_ptr(), n_sub, *p_codes(ps), fac, code,
            self.ptr(rows), n_rows, vals.data_ptr(), zeros.data_ptr(),
            ws.data_ptr(), stats.data_ptr(), w_scratch.data_ptr(),
            scale.data_ptr(), new.data_ptr(), self.ptr(d),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return scale, new, d


class AggregateFinish(Kernel):
    name = "aggregate_finish"
    source = "pyabc_tpu_torch/csrc/aggregate.cu"
    replaces = "pyabc_tpu/distance/aggregate.py:351"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"shards": 0}

    def shards(self, mom, feat, params, *, factors, scale_name: str):
        """The sharded finish: ``mom (n, 6, n_sub)`` the shards' moment
        blocks of the value columns, ``feat (rows, n_sub)`` the reservoir's
        value rows, ``params`` the params in effect -> (scale (n_sub,), the
        new params, the rows' distances)."""
        if self.on_cpu(mom, feat, params):
            return aggregate_finish_shards_plain(
                mom, feat, params, factors=factors, scale_name=scale_name)
        if scale_name not in MOMENT_SCALES:
            raise NotImplementedError(f"{self.name}: {scale_name!r} has no "
                                      f"moment form")
        n_shards, n_sub = mom.shape[0], mom.shape[-1]
        if not 0 < n_sub <= MAX_SUB:
            raise ValueError(f"{self.name}: {n_sub} sub-distances (1 to "
                             f"{MAX_SUB})")
        if len(factors) != n_sub:
            raise ValueError(f"{self.name}: {len(factors)} factors for "
                             f"{n_sub} sub-distances")
        if params.dim() != 1 or (params.numel() - n_sub) % n_sub:
            raise ValueError(f"{self.name}: params of {params.numel()} "
                             f"for {n_sub} sub-distances")
        S = (params.numel() - n_sub) // n_sub
        n_rows = feat.shape[0]
        f32 = torch.float32
        self.expect(mom, "mom", f32, (n_shards, MOMENT_ROWS, n_sub))
        self.expect(feat, "feat", f32, (n_rows, n_sub))
        self.expect(params, "params", f32, (n_sub * (S + 1),))
        dev = mom.device
        combined = torch.empty(MOMENT_ROWS, n_sub, dtype=f32, device=dev)
        scale = torch.empty(n_sub, dtype=f32, device=dev)
        new = torch.empty_like(params)
        d = torch.empty(n_rows, dtype=f32, device=dev)
        fac = (ctypes.c_float * n_sub)(*[float(x) for x in factors])
        err = _build.library().pyabc_aggregate_finish_shards(
            mom.data_ptr(), n_shards, n_sub, S,
            MOMENT_SCALES.index(scale_name), fac, params.data_ptr(),
            feat.data_ptr(), n_rows, combined.data_ptr(), scale.data_ptr(),
            new.data_ptr(), d.data_ptr(), _build.stream_ptr(dev))
        _build.check(err, f"{self.name}:shards")
        self.launches += 1
        self.mode_launches["shards"] += 1
        return scale, new, d


aggregate_accept_weight = AggregateAcceptWeight()
aggregate_refit = AggregateRefit()
aggregate_finish = AggregateFinish()
