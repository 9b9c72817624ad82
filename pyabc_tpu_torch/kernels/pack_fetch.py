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
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

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


def pack_rows_plain(theta: Sequence[torch.Tensor],
                    distance: Sequence[torch.Tensor],
                    log_weight: Sequence[torch.Tensor], *, n_keep: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: G tensors each of ``(n_cap, d)``,
    ``(n_cap,)``, ``(n_cap,)`` -> ``(G, n_keep, d + 2)`` in ``dtype``."""
    th, dist, lw = (torch.stack(list(x))[:, :n_keep]
                    for x in (theta, distance, log_weight))
    return torch.cat([th.to(dtype), cast_monotone_down(dist[..., None], dtype),
                      lw[..., None].to(dtype)], dim=-1)


def cast_rows_plain(rows: Sequence[torch.Tensor], *, n_keep: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: G tensors ``(n_cap, S)`` -> ``(G, n_keep, S)``
    in ``dtype``."""
    return torch.stack([r[:n_keep] for r in rows]).to(dtype)


def pack_models_plain(ms: Sequence[torch.Tensor], *,
                      n_keep: int) -> torch.Tensor:
    """Plain PyTorch version: G int32 tensors ``(n_cap,)`` ->
    ``(G, n_keep)`` int8."""
    return torch.stack([m[:n_keep] for m in ms]).to(torch.int8)


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


class PackFetch(Kernel):
    name = "pack_fetch"
    source = "pyabc_tpu_torch/csrc/pack_fetch.cu"
    replaces = "pyabc_tpu/ops/pack.py:78"

    def _code(self, dtype: torch.dtype) -> int:
        try:
            return DTYPE_CODES[dtype]
        except KeyError:
            raise ValueError(f"{self.name}: unsupported dtype {dtype}") \
                from None

    def rows(self, theta: Sequence[torch.Tensor],
             distance: Sequence[torch.Tensor],
             log_weight: Sequence[torch.Tensor], *, n_keep: int,
             dtype: torch.dtype) -> torch.Tensor:
        theta, distance, log_weight = (list(theta), list(distance),
                                       list(log_weight))
        if self.on_cpu(*theta, *distance, *log_weight):
            return pack_rows_plain(theta, distance, log_weight,
                                   n_keep=n_keep, dtype=dtype)
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
                out[part].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self.launches += 1
        return out

    def sumstats(self, rows: Sequence[torch.Tensor], *, n_keep: int,
                 dtype: torch.dtype) -> torch.Tensor:
        rows = list(rows)
        if self.on_cpu(*rows):
            return cast_rows_plain(rows, n_keep=n_keep, dtype=dtype)
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
                out[g0:g0 + MAX_GEN].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self.launches += 1
        return out

    def models(self, ms: Sequence[torch.Tensor], *,
               n_keep: int) -> torch.Tensor:
        """G reservoirs' int32 model columns -> ``(G, n_keep)`` int8."""
        ms = list(ms)
        if self.on_cpu(*ms):
            return pack_models_plain(ms, n_keep=n_keep)
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
                out[g0:g0 + MAX_GEN].data_ptr(), _build.stream_ptr(dev))
            _build.check(err, self.name)
            self.launches += 1
        return out


pack_fetch = PackFetch()
