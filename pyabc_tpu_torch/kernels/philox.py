"""K1: Philox4x32-10, the counter-based generator of the port.

``csrc/philox.cuh`` is the device version, called from inside K2 (the
proposal) and K4 (the Lotka-Volterra noise). This module is its plain
PyTorch twin, word for word, on int64 tensors, so that a run on the CPU
draws the same proposal numbers as a run on the card for the same seed.

It replaces ``pyabc_tpu/core/random.py::{generation_key, round_key}`` and
the ``jax.random`` draws of the lanes as a declared difference: the port
does not reproduce threefry's bits.

A draw's counter is ``(lane, draw block, generation, tag * max_rounds +
round)`` and its key the run's seed; the round is read on the device from
the round counters (``counters[ROUND]``, the layout of ``compact.py``), so
no host read is needed to place a draw.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import _build

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
#: 2 pi rounded to float32 (the device constant)
TWO_PI_F32 = 6.28318548202514648
#: index of the round in the int32 round counters
ROUND = 1

#: stream tags: calibration rounds, the generation-0 prior, the transition
#: proposal, the simulator's noise, the stochastic accept's uniform, and the
#: model index of a run over several models (the prior-model draw, the
#: ancestor model and its perturbation; a single-model run never draws it)
CALIBRATION, PRIOR, TRANSITION, SIM_NOISE, ACCEPT, MODEL = range(6)


@dataclass(frozen=True)
class PhiloxStream:
    """Where a round's draws sit: key (the seed), generation, stream tag
    and the device round counters the round index is read from."""

    seed: int
    generation: int
    tag: int
    max_rounds: int
    counters: torch.Tensor

    @property
    def key(self) -> tuple[int, int]:
        s = int(self.seed) % (1 << 64)
        return s & MASK32, s >> 32

    def c3(self) -> torch.Tensor:
        """The counter's last word as a 0-dim int64 device tensor."""
        return (self.tag * self.max_rounds
                + self.counters[ROUND].to(torch.int64))


def _mulhilo(m: int, c: torch.Tensor):
    """(hi, lo) 32-bit words of m * c for c < 2^32 on int64 tensors: c is
    split into 16-bit halves so no product reaches 2^63."""
    a = m * (c & 0xFFFF)
    b = m * (c >> 16)
    hi = (b + (a >> 16)) >> 16
    lo = (((b & 0xFFFF) << 16) + a) & MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, key: tuple[int, int]):
    """Four output words (int64 tensors in [0, 2^32)) of the counters
    ``c0..c3`` (int64 tensors or ints, broadcast together)."""
    dev = next(c.device for c in (c0, c1, c2, c3)
               if isinstance(c, torch.Tensor))
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=dev)
                      for c in (c0, c1, c2, c3))
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_of(x: torch.Tensor) -> torch.Tensor:
    """((x >> 9) + 0.5) * 2^-23 in float32: exact, in (0, 1)."""
    return ((x >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def box_muller(a: torch.Tensor, b: torch.Tensor, second: bool):
    r = torch.sqrt(-2.0 * torch.log(a))
    t = TWO_PI_F32 * b
    return r * (torch.sin(t) if second else torch.cos(t))


def lane_blocks(stream: PhiloxStream, lanes: torch.Tensor,
                blocks: torch.Tensor):
    """The four words of block ``blocks`` of each lane (broadcast)."""
    return philox4x32_10(lanes, blocks, stream.generation, stream.c3(),
                         stream.key)


def uniforms(stream: PhiloxStream, lanes: torch.Tensor, block: int,
             word: int) -> torch.Tensor:
    """One uniform per lane: word ``word`` of block ``block``."""
    return uniform_of(lane_blocks(stream, lanes, torch.tensor(
        block, device=lanes.device))[word])


def normals(stream: PhiloxStream, lanes: torch.Tensor, base: int,
            n: int) -> torch.Tensor:
    """``(len(lanes), n)`` normals: number j from block base + j // 4,
    Box-Muller pair (j % 4) // 2, cos for even j and sin for odd j."""
    nb = (n + 3) // 4
    blocks = base + torch.arange(nb, dtype=torch.int64, device=lanes.device)
    w = lane_blocks(stream, lanes[:, None], blocks[None, :])
    u = [uniform_of(x) for x in w]
    z = torch.stack([box_muller(u[0], u[1], False),
                     box_muller(u[0], u[1], True),
                     box_muller(u[2], u[3], False),
                     box_muller(u[2], u[3], True)], dim=-1)
    return z.reshape(lanes.shape[0], nb * 4)[:, :n]


def generator_stream(generator: torch.Generator,
                     device: torch.device) -> PhiloxStream:
    """A simulator-noise stream for a call outside the rounds: keyed by the
    generator's seed, its round a number drawn from the generator on the
    device (so nothing is read back and each call moves on)."""
    counters = torch.zeros(4, dtype=torch.int32, device=device)
    counters[ROUND] = torch.randint(
        0, 2 ** 31 - 1, (), generator=generator, device=device,
        dtype=torch.int32)
    return PhiloxStream(generator.initial_seed(), 0, SIM_NOISE, 1, counters)


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def philox_blocks_cuda(counters: torch.Tensor, key: tuple[int, int]):
    """Card check of ``philox.cuh``: ``(N, 4)`` counters -> the words
    (int64, ``(N, 4)``), their uniforms and the four Box-Muller normals of
    each block, computed by the device functions the kernels use. Not on
    the main path (the kernels call the device functions inline)."""
    if counters.device.type != "cuda":
        raise ValueError("philox_blocks_cuda needs a CUDA tensor")
    ctr = _as_i32_bits(counters).contiguous()
    n = ctr.shape[0]
    words = torch.empty(n, 4, dtype=torch.int32, device=ctr.device)
    uni = torch.empty(n, 4, dtype=torch.float32, device=ctr.device)
    nrm = torch.empty(n, 4, dtype=torch.float32, device=ctr.device)
    err = _build.library().pyabc_philox_blocks(
        ctr.data_ptr(), n, key[0], key[1], words.data_ptr(),
        uni.data_ptr(), nrm.data_ptr(), _build.stream_ptr(ctr.device))
    _build.check(err, "philox_blocks")
    return words.to(torch.int64) & MASK32, uni, nrm
