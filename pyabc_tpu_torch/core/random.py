"""Where a generation's and a round's draws sit
(``pyabc_tpu/core/random.py`` counterpart).

The JAX package folds the generation and the round into a threefry key.
The port's draws sit at Philox counters ``(lane, block, generation word,
tag * stride + round)`` keyed by the run's seed (``kernels/philox.py``), so
a generation's key is its generation word and a round's key is that word
with the round index. Calibration draws as the generation word 2^32 - 1;
a speculative round of generation t (the pipelined loop's eps = +inf round,
the JAX package's ``fold_in(generation_key, 1 << 20)``) draws as the word
``t | 2^31``, which no generation, round or tag of the run reaches.
"""
from __future__ import annotations

from typing import NamedTuple

#: the generation word of the calibration rounds' draws
CALIBRATION_GENERATION = 2 ** 32 - 1
#: the bit that marks a speculative round's generation word
SPECULATIVE_BIT = 1 << 31


class RoundKey(NamedTuple):
    """The generation word and the round index of one round's draws."""

    generation: int
    round: int


def generation_key(t: int) -> int:
    """The generation word of generation t (t = -1: the calibration)."""
    if t == -1:
        return CALIBRATION_GENERATION
    if not 0 <= t < SPECULATIVE_BIT:
        raise ValueError(f"generation {t} outside [0, 2^31)")
    return int(t)


def round_key(gen_key: int, round_idx: int) -> RoundKey:
    return RoundKey(int(gen_key), int(round_idx))


def speculative_key(t: int) -> RoundKey:
    """The key of generation t's speculative round (round 0 of its own
    generation word)."""
    return RoundKey(generation_key(t) | SPECULATIVE_BIT, 0)
