"""The hand-written CUDA kernels of the port and their launch counts.

Each wrapper sends CPU tensors to its plain PyTorch version and launches
its CUDA kernel (``pyabc_tpu_torch/csrc``) on CUDA tensors. Importing this
package builds nothing: the kernels are compiled at first launch.
"""
from .compact import compact_round, compact_round_plain
from .lv_simulate import lv_simulate, lv_simulate_plain
from .mvn_logpdf import mvn_mixture_logpdf, mvn_mixture_logpdf_plain
from .pnorm_accept import pnorm_accept_weight, pnorm_accept_weight_plain

#: every kernel wrapper, in the order of ROADMAP queue B (K3-K6)
KERNELS = (mvn_mixture_logpdf, lv_simulate, pnorm_accept_weight,
           compact_round)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


__all__ = [
    "KERNELS", "compact_round", "compact_round_plain", "launch_counts",
    "lv_simulate", "lv_simulate_plain", "mvn_mixture_logpdf",
    "mvn_mixture_logpdf_plain", "pnorm_accept_weight",
    "pnorm_accept_weight_plain", "reset_launch_counts",
]
