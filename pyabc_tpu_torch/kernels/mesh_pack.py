"""K24e: the mesh pack and unpack, a generation's one gather packed.

Counterpart of the reshape and concatenation of
``pyabc_tpu/inference/util.py::_HybridShards.rows`` (``:2575-2577``) and of
the sharded chunk's ``out_specs=P(None, axis)`` (``:3040-3046``); the CUDA
kernels are ``csrc/mesh_pack.cu``. A device mesh rank owns v of the run's
n shards; after its generation ``mesh_pack(pieces)`` copies its pieces (the
counters and the ``(v, 4)`` table, its reservoir blocks' columns, its
moment blocks: any contiguous tensors of 4-byte elements) into one
``(W,)`` int32 send buffer, float32 pieces by their bits. After the gather
``mesh_unpack(buf, dsts)`` scatters the ``(w, W)`` buffer into the global
arrays: piece k of rank r lands at elements ``[r len_k, (r + 1) len_k)``
of ``dsts[k]`` (rank r's shards are the global shards ``[r v, (r + 1) v)``,
so the tiles in rank order are the shard-blocked layout); a ``None``
destination skips its piece. Both are exact copies: the plain versions are
``torch.cat`` and slice copies of the same words.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .base import Kernel

#: pieces a launch takes (the kernels' argument block)
MAX_PIECES = 16


def words(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of 4-byte elements as its flat int32 words (a
    view: the same memory)."""
    if t.element_size() != 4 or not t.is_contiguous():
        raise ValueError(f"mesh pieces are contiguous 4-byte tensors, got "
                         f"{t.dtype} {'' if t.is_contiguous() else 'strided'}")
    flat = t.reshape(-1)
    return flat if flat.dtype == torch.int32 else flat.view(torch.int32)


def mesh_pack_plain(pieces: list[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the pack -> the ``(W,)`` int32 buffer."""
    return torch.cat([words(p) for p in pieces])


def mesh_unpack_plain(buf: torch.Tensor,
                      dsts: list[torch.Tensor | None],
                      lens: list[int]) -> None:
    """Plain PyTorch version of the unpack (in place): ``lens`` the
    pieces' word counts a rank."""
    w = buf.shape[0]
    off = 0
    for dst, n in zip(dsts, lens):
        if dst is not None:
            words(dst).copy_(buf[:, off:off + n].reshape(w * n))
        off += n


def _check(pieces, what: str) -> None:
    if not 0 < len(pieces) <= MAX_PIECES:
        raise ValueError(f"{what}: 1 to {MAX_PIECES} pieces, got "
                         f"{len(pieces)}")


class MeshPack(Kernel):
    name = "mesh_pack"
    source = "pyabc_tpu_torch/csrc/mesh_pack.cu"
    replaces = "pyabc_tpu/inference/util.py:2575"

    def __call__(self, pieces: list[torch.Tensor]) -> torch.Tensor:
        _check(pieces, self.name)
        flat = [words(p) for p in pieces]
        if self.on_cpu(*flat):
            return mesh_pack_plain(pieces)
        lens = [int(f.numel()) for f in flat]
        dev = flat[0].device
        out = torch.empty(sum(lens), dtype=torch.int32, device=dev)
        n = len(flat)
        src = (ctypes.c_void_p * n)(*[f.data_ptr() for f in flat])
        ln = (ctypes.c_longlong * n)(*lens)
        err = _build.library().pyabc_mesh_pack(
            n, ctypes.cast(src, ctypes.c_void_p),
            ctypes.cast(ln, ctypes.c_void_p), out.data_ptr(),
            _build.stream_ptr(dev))
        _build.check(err, self.name)
        self.launches += 1
        return out


class MeshUnpack(Kernel):
    name = "mesh_unpack"
    source = "pyabc_tpu_torch/csrc/mesh_pack.cu"
    replaces = "pyabc_tpu/inference/util.py:3049"

    def __call__(self, buf: torch.Tensor, dsts: list[torch.Tensor | None],
                 lens: list[int]) -> None:
        """``buf (w, W)`` int32, ``dsts`` the global destinations (each
        ``w`` times its piece, or None to skip), ``lens`` the pieces' word
        counts a rank (summing to W)."""
        _check(dsts, self.name)
        if len(lens) != len(dsts):
            raise ValueError(f"{self.name}: {len(dsts)} destinations and "
                             f"{len(lens)} lengths")
        w, W = buf.shape
        if sum(lens) != W:
            raise ValueError(f"{self.name}: the pieces' {sum(lens)} words "
                             f"are not the buffer's {W}")
        flat = [None if d is None else words(d) for d in dsts]
        for f, n in zip(flat, lens):
            if f is not None and f.numel() != w * n:
                raise ValueError(f"{self.name}: a destination of "
                                 f"{f.numel()} words for {w} x {n}")
        if self.on_cpu(buf, *[f for f in flat if f is not None]):
            mesh_unpack_plain(buf, dsts, lens)
            return
        self.expect(buf, "buf", torch.int32, (w, W))
        n = len(flat)
        dst = (ctypes.c_void_p * n)(*[None if f is None else f.data_ptr()
                                      for f in flat])
        ln = (ctypes.c_longlong * n)(*[int(x) for x in lens])
        err = _build.library().pyabc_mesh_unpack(
            n, ctypes.cast(dst, ctypes.c_void_p),
            ctypes.cast(ln, ctypes.c_void_p), buf.data_ptr(), w,
            _build.stream_ptr(buf.device))
        _build.check(err, self.name)
        self.launches += 1


mesh_pack = MeshPack()
mesh_unpack = MeshUnpack()
