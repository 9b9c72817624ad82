"""K10: the narrowing pack of a chunk's rows before the host read.

Counterpart of ``pyabc_tpu/ops/pack.py::pack_outs`` with
``_cast_monotone_down``; the CUDA kernels are ``csrc/pack_fetch.cu``.
``rows`` packs theta, distance and log weight of the first ``n_keep``
reservoir rows of each generation into one ``(G, n_keep, d + 2)`` buffer
in the fetch dtype, the distance rounded DOWN so that the stored invariant
``distance <= eps_used`` survives the cast; ``sumstats`` narrows the sum
stats of the generations History stores. Both take one tensor per
generation (each generation's reservoir) and read them in place.
``ops/pack.py`` calls this wrapper. A run over several models also packs
each kept row's model index into one ``(G, n_keep)`` int8 buffer
(``models``, ``pack_outs(keep_m=True)``), read in the same fetch.

Merge mode (K24c, sharded fused sampling; ``merge=(ns, n_shards,
cap_loc)`` on any of the three, counted in ``mode_launches["merge"]``):
``pack_outs(merge_index=)`` (``pack.py:105-110``). Each generation's
reservoir is shard-blocked; its kept rows come out in dense accepted order,
row i < n_g from the gather of ``ops/shard.py::merge_index(n_g, n_shards,
cap_loc)`` (the kernel computes it from n_g), row i >= n_g (a listed
size's smaller generation) from row i.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from ..ops.shard import merge_index
from . import _build
from .base import Kernel

#: fetch dtype -> the kernels' dtype code
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: generations per launch (the kernels' pointer table)
MAX_GEN = 32


def cast_monotone_down(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Narrowing cast whose result never exceeds ``x``."""
    if dtype == torch.float32:
        return x.to(dtype)
    step = 2.0 ** -10 if dtype == torch.float16 else 2.0 ** -7
    down = x * torch.where(x >= 0, 1.0 - step, 1.0 + step)
    cast = x.to(dtype)
    over = cast.to(x.dtype) > x
    return torch.where(over, down.to(dtype), cast)


def merged_rows(x: torch.Tensor, n_keep: int, merge) -> torch.Tensor:
    """``(G, n_cap, ...)`` -> ``(G, n_keep, ...)``: the first n_keep rows,
    or under ``merge = (ns, n_shards, cap_loc)`` generation g's kept rows
    in dense order (``merge_index``), then its rows n_g..n_keep."""
    if merge is None:
        return x[:, :n_keep]
    ns, n_shards, cap_loc = merge
    idx = [torch.from_numpy(np.concatenate([
        merge_index(n, n_shards, cap_loc),
        np.arange(n, n_keep, dtype=np.int32)]).astype(np.int64))
        for n in ns]
    return torch.stack([x[g][i.to(x.device)] for g, i in enumerate(idx)])


def pack_rows_plain(theta: Sequence[torch.Tensor],
                    distance: Sequence[torch.Tensor],
                    log_weight: Sequence[torch.Tensor], *, n_keep: int,
                    dtype: torch.dtype, merge=None) -> torch.Tensor:
    """Plain PyTorch version: G tensors each of ``(n_cap, d)``,
    ``(n_cap,)``, ``(n_cap,)`` -> ``(G, n_keep, d + 2)`` in ``dtype``."""
    th, dist, lw = (merged_rows(torch.stack(list(x)), n_keep, merge)
                    for x in (theta, distance, log_weight))
    return torch.cat([th.to(dtype), cast_monotone_down(dist[..., None], dtype),
                      lw[..., None].to(dtype)], dim=-1)


def cast_rows_plain(rows: Sequence[torch.Tensor], *, n_keep: int,
                    dtype: torch.dtype, merge=None) -> torch.Tensor:
    """Plain PyTorch version: G tensors ``(n_cap, S)`` -> ``(G, n_keep, S)``
    in ``dtype``."""
    return merged_rows(torch.stack(list(rows)), n_keep, merge).to(dtype)


def pack_models_plain(ms: Sequence[torch.Tensor], *, n_keep: int,
                      merge=None) -> torch.Tensor:
    """Plain PyTorch version: G int32 tensors ``(n_cap,)`` ->
    ``(G, n_keep)`` int8."""
    return merged_rows(torch.stack(list(ms)), n_keep, merge).to(torch.int8)


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _merge_args(merge, part: slice, G: int, n_keep: int, n_cap: int):
    """The C arguments (sizes array, shards, cap_loc) of a launch over the
    generations ``part``: nullptr, 0, 0 without a merge."""
    if merge is None:
        return None, 0, 0
    ns, n_shards, cap_loc = merge
    if len(ns) != G or n_shards * cap_loc != n_cap or any(
            not 0 <= n <= n_keep for n in ns):
        raise ValueError(f"pack_fetch: merge {merge} does not fit {G} "
                         f"generations of {n_cap} rows, n_keep {n_keep}")
    part_ns = [int(n) for n in ns[part]]
    return (ctypes.c_int * len(part_ns))(*part_ns), int(n_shards), int(cap_loc)


class PackFetch(Kernel):
    name = "pack_fetch"
    source = "pyabc_tpu_torch/csrc/pack_fetch.cu"
    replaces = "pyabc_tpu/ops/pack.py:78"

    def __init__(self):
        super().__init__()
        self.mode_launches = {"merge": 0}

    def _count(self, merge) -> None:
        self.launches += 1
        if merge is not None:
            self.mode_launches["merge"] += 1

    def _code(self, dtype: torch.dtype) -> int:
        try:
            return DTYPE_CODES[dtype]
        except KeyError:
            raise ValueError(f"{self.name}: unsupported dtype {dtype}") \
                from None

    def rows(self, theta: Sequence[torch.Tensor],
             distance: Sequence[torch.Tensor],
             log_weight: Sequence[torch.Tensor], *, n_keep: int,
             dtype: torch.dtype, merge=None) -> torch.Tensor:
        theta, distance, log_weight = (list(theta), list(distance),
                                       list(log_weight))
        if self.on_cpu(*theta, *distance, *log_weight):
            return pack_rows_plain(theta, distance, log_weight,
                                   n_keep=n_keep, dtype=dtype, merge=merge)
        G = len(theta)
        if not G or len(distance) != G or len(log_weight) != G:
            raise ValueError(f"{self.name}: give theta, distance and "
                             f"log_weight of the same generations")
        n_cap, d = theta[0].shape
        if not 0 <= n_keep <= n_cap:
            raise ValueError(f"{self.name}: n_keep {n_keep} outside the "
                             f"reservoir ({n_cap})")
        for g in range(G):
            self.expect(theta[g], "theta", torch.float32, (n_cap, d))
            self.expect(distance[g], "distance", torch.float32, (n_cap,))
            self.expect(log_weight[g], "log_weight", torch.float32,
                        (n_cap,))
        code = self._code(dtype)
        dev = theta[0].device
        out = torch.empty(G, n_keep, d + 2, dtype=dtype, device=dev)
        lib = _build.library()
        for g0 in range(0, G, MAX_GEN):
            part = slice(g0, g0 + MAX_GEN)
            k = len(theta[part])
            err = lib.pyabc_pack_rows(
                k, _pointers(theta[part]), _pointers(distance[part]),
                _pointers(log_weight[part]), n_keep, d, code,
                *_merge_args(merge, part, G, n_keep, n_cap),
                out[part].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self._count(merge)
        return out

    def sumstats(self, rows: Sequence[torch.Tensor], *, n_keep: int,
                 dtype: torch.dtype, merge=None) -> torch.Tensor:
        rows = list(rows)
        if self.on_cpu(*rows):
            return cast_rows_plain(rows, n_keep=n_keep, dtype=dtype,
                                   merge=merge)
        G = len(rows)
        if not G:
            raise ValueError(f"{self.name}: no generations")
        n_cap, S = rows[0].shape
        if not 0 <= n_keep <= n_cap:
            raise ValueError(f"{self.name}: n_keep {n_keep} outside the "
                             f"reservoir ({n_cap})")
        for r in rows:
            self.expect(r, "sumstats", torch.float32, (n_cap, S))
        code = self._code(dtype)
        dev = rows[0].device
        out = torch.empty(G, n_keep, S, dtype=dtype, device=dev)
        lib = _build.library()
        for g0 in range(0, G, MAX_GEN):
            part = rows[g0:g0 + MAX_GEN]
            err = lib.pyabc_cast_rows(
                len(part), _pointers(part), n_keep, S, code,
                *_merge_args(merge, slice(g0, g0 + MAX_GEN), G, n_keep,
                             n_cap),
                out[g0:g0 + MAX_GEN].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self._count(merge)
        return out

    def models(self, ms: Sequence[torch.Tensor], *, n_keep: int,
               merge=None) -> torch.Tensor:
        """G reservoirs' int32 model columns -> ``(G, n_keep)`` int8."""
        ms = list(ms)
        if self.on_cpu(*ms):
            return pack_models_plain(ms, n_keep=n_keep, merge=merge)
        G = len(ms)
        if not G:
            raise ValueError(f"{self.name}: no generations")
        n_cap = ms[0].shape[0]
        if not 0 <= n_keep <= n_cap:
            raise ValueError(f"{self.name}: n_keep {n_keep} outside the "
                             f"reservoir ({n_cap})")
        for m in ms:
            self.expect(m, "m", torch.int32, (n_cap,))
        dev = ms[0].device
        out = torch.empty(G, n_keep, dtype=torch.int8, device=dev)
        lib = _build.library()
        for g0 in range(0, G, MAX_GEN):
            part = ms[g0:g0 + MAX_GEN]
            err = lib.pyabc_pack_models(
                len(part), _pointers(part), n_keep,
                *_merge_args(merge, slice(g0, g0 + MAX_GEN), G, n_keep,
                             n_cap),
                out[g0:g0 + MAX_GEN].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self._count(merge)
        return out


pack_fetch = PackFetch()
