"""Small shared helpers: device resolution, bucket sizing and the error for
what is not ported yet."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card. Without CUDA that raises: the port
    never carries on quietly on the CPU; pass ``device="cpu"`` for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "pyabc_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: cpu or cuda")
    return dev


def pow2_bucket(n: int, lo: int = 64, hi: int | None = None) -> int:
    """Round n up to a power-of-two bucket in [lo, hi]."""
    b = lo
    while b < n and (hi is None or b < hi):
        b *= 2
    return b if hi is None else min(b, hi)


def pick_batch(n: int) -> int:
    """Lanes per proposal round (``sampler/batched.py::_pick_B`` with its
    defaults: a 0.5 acceptance estimate, 1.3 overshoot, 256 to 2^17
    lanes): enough for one round to fill n."""
    return pow2_bucket(max(int(n / 0.5 * 1.3), 256), 256, 1 << 17)


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a configuration outside the ported path raises."""
    return NotImplementedError(
        f"{what} is not ported to pyabc_tpu_torch yet (ROADMAP queue A, "
        f"item {item})")
