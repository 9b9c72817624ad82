"""Per-generation health word (``pyabc_tpu/ops/health.py`` counterpart;
K11 in ROADMAP queue B).

One int32 bitmask per generation, computed on the device from values the
generation step already holds and read with the chunk's packed fetch (no
extra sync). The bit layout is the JAX package's. ``generation_health`` is
the K11 wrapper (``kernels/generation_health.py``): the CUDA kernel on CUDA
tensors, the plain version on the CPU.
"""
from __future__ import annotations

from ..kernels.generation_health import (BIT_ACC_COLLAPSE, BIT_EPS_NONFINITE,
                                         BIT_EPS_STALL, BIT_ESS_FLOOR,
                                         BIT_NAMES, BIT_NAN_DISTANCE,
                                         BIT_NAN_THETA, BIT_NAN_WEIGHT,
                                         BIT_PSD_FAIL, BIT_WEIGHT_ZERO,
                                         HEALTH_OK, generation_health)

__all__ = ["BIT_ACC_COLLAPSE", "BIT_EPS_NONFINITE", "BIT_EPS_STALL",
           "BIT_ESS_FLOOR", "BIT_NAMES", "BIT_NAN_DISTANCE", "BIT_NAN_THETA",
           "BIT_NAN_WEIGHT", "BIT_PSD_FAIL", "BIT_WEIGHT_ZERO", "HEALTH_OK",
           "decode", "generation_health"]


def decode(word: int) -> list[str]:
    return [name for i, name in enumerate(BIT_NAMES) if word & (1 << i)]
