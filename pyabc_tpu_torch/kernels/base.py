"""Common shape of a kernel wrapper.

A wrapper is a callable object with a plain integer ``launches`` count. A
tensor on the CPU goes to the kernel's plain PyTorch version (which sits in
the same module); a CUDA tensor launches the hand-written kernel or
raises. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch


class Kernel:
    #: kernel name as chip_smoke.py reports it
    name: str = ""
    #: "cuda" (hand-written CUDA C++ in pyabc_tpu_torch/csrc)
    route: str = "cuda"
    #: source file in the repository
    source: str = ""
    #: file:line of the TPU program it replaces
    replaces: str = ""

    def __init__(self):
        self.launches = 0

    @staticmethod
    def on_cpu(*tensors: torch.Tensor) -> bool:
        """True when every tensor lies on the CPU (plain version); raises
        for a mix of devices or a device that is neither CPU nor CUDA."""
        kinds = {t.device.type for t in tensors}
        if kinds == {"cpu"}:
            return True
        if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
            return False
        raise ValueError(
            f"kernel inputs must all lie on one CUDA device or all on the "
            f"CPU, got {sorted(str(t.device) for t in tensors)}"
        )

    @staticmethod
    def expect(t: torch.Tensor, name: str, dtype: torch.dtype,
               shape: tuple) -> None:
        """Check dtype, shape (``None`` = any extent) and contiguity."""
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != ts for s, ts in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")

    @staticmethod
    def ptr(t: torch.Tensor | None) -> int | None:
        return None if t is None else t.data_ptr()


class LaneKernel(Kernel):
    """A simulator kernel drawing on a round's Philox stream at its lanes'
    global numbers (the stream's ``lane0`` plus the lane's index): a launch
    over a block of a round whose first lane is not 0 (a device mesh
    rank's) also counts in its ``lane_base`` mode."""

    def __init__(self):
        super().__init__()
        self.mode_launches = {"lane_base": 0}

    def count_launch(self, stream) -> None:
        self.launches += 1
        if stream is not None and stream.lane0:
            self.mode_launches["lane_base"] += 1
