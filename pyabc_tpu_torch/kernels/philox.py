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
#: proposal, the simulator's noise, the stochastic accept's uniform, the
#: model index of a run over several models (the prior-model draw, the
#: ancestor model and its perturbation; a single-model run never draws it)
#: and the bootstrap ancestors of the adaptive population size (K16: block
#: ``(model << 8) | bootstrap`` of lane = slot, at round 0)
CALIBRATION, PRIOR, TRANSITION, SIM_NOISE, ACCEPT, MODEL, BOOT = range(7)


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
    """(hi, lo) 32-bit words of m * c for m, c < 2^32 on int64 tensors. The
    int64 product wraps modulo 2^64 and so keeps the bits of the unsigned
    64-bit product: the masks take its two halves (the arithmetic shift's
    sign extension lies above bit 31 and is masked off)."""
    prod = m * c
    return (prod >> 32) & MASK32, prod & MASK32


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


# ---------------------------------------------------------------- Poisson
#: a Poisson draw owns 2^POISSON_BLOCK_BITS blocks (csrc/philox.cuh)
POISSON_BLOCK_BITS = 12
#: the uniforms one draw may use: Knuth's iterations, two per PTRS attempt
POISSON_MAX_UNIFORMS = 4 << POISSON_BLOCK_BITS
#: draw numbers of a lane (leap * n_channels + channel) stay below this
POISSON_MAX_DRAWS = 1 << (32 - POISSON_BLOCK_BITS)
#: blocks a vectorized pass of the plain sampler takes at once
_KNUTH_BLOCKS, _PTRS_BLOCKS = 8, 2


def poisson_uniforms(stream: PhiloxStream, lanes: torch.Tensor,
                     draws: torch.Tensor, first_block: int,
                     n_blocks: int) -> torch.Tensor:
    """``(N, 4 * n_blocks)`` uniforms of draws ``draws`` of lanes ``lanes``
    (int64 ``(N,)`` each): uniform i of a draw is word i % 4 of its block
    (draw << 12) | (i // 4), from block ``first_block`` on."""
    blk = torch.arange(first_block, first_block + n_blocks,
                       dtype=torch.int64, device=lanes.device)
    w = lane_blocks(stream, lanes[:, None],
                    (draws[:, None] << POISSON_BLOCK_BITS) | blk[None, :])
    return torch.stack([uniform_of(x) for x in w], dim=-1).reshape(
        lanes.shape[0], 4 * n_blocks)


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` as one rounded division (``c / tensor`` in PyTorch is a
    reciprocal and a product, two roundings)."""
    return torch.full_like(t, c) / t


def _poisson_knuth(stream, lanes, draws, lam):
    k = torch.zeros_like(lam)
    log_prod = torch.zeros_like(lam)
    i = 0
    act = log_prod > -lam  # NaN: no iteration, k - 1 = -1 as in JAX
    while i < POISSON_MAX_UNIFORMS and bool(act.any()):
        sel = act.nonzero()[:, 0]
        # a first pass of two blocks serves most small rates
        nb = 2 if i == 0 else _KNUTH_BLOCKS
        lu = torch.log(poisson_uniforms(stream, lanes[sel], draws[sel],
                                        i // 4, nb))
        kk, lp, lm = k[sel], log_prod[sel], -lam[sel]
        for j in range(4 * nb):
            a = lp > lm
            if j % 4 == 0 and not bool(a.any()):
                break
            kk = torch.where(a, kk + 1.0, kk)
            lp = torch.where(a, lp + lu[:, j], lp)
        k[sel], log_prod[sel] = kk, lp
        i += 4 * nb
        act = log_prod > -lam
    return k - 1.0


def _poisson_ptrs(stream, lanes, draws, lam):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + _rdiv(1.1328, b - 3.4)
    v_r = 0.9277 - _rdiv(3.6224, b - 2.0)
    two_a = 2.0 * a
    out = torch.full_like(lam, -1.0)
    todo = torch.ones_like(lam, dtype=torch.bool)
    j = 0
    while j < POISSON_MAX_UNIFORMS // 2 and bool(todo.any()):
        sel = todo.nonzero()[:, 0]
        uni = poisson_uniforms(stream, lanes[sel], draws[sel], j // 2,
                               _PTRS_BLOCKS)
        lm, ll, bb, aa = lam[sel], log_lam[sel], b[sel], a[sel]
        ia, vr, ta = inv_alpha[sel], v_r[sel], two_a[sel]
        got = torch.full_like(lm, -1.0)
        done = torch.zeros_like(lm, dtype=torch.bool)
        for att in range(2 * _PTRS_BLOCKS):
            u = uni[:, 2 * att] - 0.5
            v = uni[:, 2 * att + 1]
            us = 0.5 - u.abs()
            k = torch.floor(((ta / us + bb) * u + lm) + 0.43)
            s = torch.log((v * ia) / (aa / (us * us) + bb))
            t = (-lm + k * ll) - torch.lgamma(k + 1.0)
            accept1 = (us >= 0.07) & (v <= vr)
            reject = (k < 0) | ((us < 0.013) & (v > us))
            acc = (accept1 | (~reject & (s <= t))) & ~done
            got = torch.where(acc, k, got)
            done = done | acc
        out[sel] = got
        todo[sel] = ~done
        j += 2 * _PTRS_BLOCKS
    return out


def poisson_plain(stream: PhiloxStream, lanes: torch.Tensor,
                  draws: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``philox.cuh::poisson``: float32 Poisson counts of
    rates ``lam`` for draw ``draws`` of lane ``lanes`` (broadcast) on
    ``stream`` -- 0 at rate 0, Knuth below 10 and for NaN (-1), PTRS from 10
    up, each operation rounded on its own as the kernel writes it."""
    shape = lam.shape
    lam = lam.to(torch.float32).reshape(-1)
    lanes = lanes.to(torch.int64).expand(shape).reshape(-1)
    draws = torch.as_tensor(draws, dtype=torch.int64,
                            device=lam.device).expand(shape).reshape(-1)
    out = torch.zeros_like(lam)
    knuth = (torch.isnan(lam) | (lam < 10.0)) & (lam != 0)
    ptrs = ~torch.isnan(lam) & (lam >= 10.0)
    for mask, fn in ((knuth, _poisson_knuth), (ptrs, _poisson_ptrs)):
        idx = mask.nonzero()[:, 0]
        if idx.numel():
            out[idx] = fn(stream, lanes[idx], draws[idx], lam[idx])
    return out.reshape(shape)


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
