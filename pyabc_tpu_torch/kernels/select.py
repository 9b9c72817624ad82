"""Workspace of the radix selection shared by K7 and K9 (``csrc/select.cuh``):
per column a 56-byte state, then the 256-bin counts of each target, then
(weighted selection only) their double weight sums."""
from __future__ import annotations

import torch

STATE_BYTES = 56
BINS = 256


def workspace(columns: int, targets: int, weighted: bool,
              device: torch.device) -> torch.Tensor:
    """Uninitialized workspace; the kernels zero it before each use."""
    nbytes = columns * (STATE_BYTES + targets * BINS * 4
                        + (targets * BINS * 8 if weighted else 0))
    return torch.empty(nbytes, dtype=torch.uint8, device=device)
