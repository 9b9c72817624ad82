"""K4: the Gaussian toy's simulator of one proposal round (BASELINE
config 1), and the conjugate toy's mean-only simulator.

Counterpart of ``pyabc_tpu/models/gaussian.py::make_gaussian_model``
vmapped over a round; the CUDA kernel is ``csrc/gaussian.cu``. Each lane
draws ``n`` normals from the round's simulator-noise Philox stream (K1:
normal number j of the lane), forms ``x = mu + |sigma| z`` and writes its
mean and population std into the flat ``(B, S)`` row in SumStatSpec order:
``columns = (col_mean, col_std)``, a negative column being a statistic the
observation leaves out (``(0, 1)`` for ``(mean, std)``, ``(0, -1)`` for an
observed mean alone). The plain version draws the same words with the plain
K1 and applies ``models.gaussian.gaussian_sim``. The draws follow
``jax.random``'s law, not its bits (a declared difference).

``mean_only_simulate`` is ``pyabc_tpu/models/gaussian.py::
make_mean_only_model`` (and each model of ``model_selection.py::
tractable_pair``) vmapped over a round, the second kernel of
``csrc/gaussian.cu``: lane b writes ``theta[b, 0] + noise_sd * z`` with z
normal number 0 of its Philox lane on the round's simulator-noise stream,
as the ``(B, 1)`` rows of the toy's one statistic ``"x"``; the plain
version is ``models.gaussian.mean_only_sim`` on the plain K1's normals.
"""
from __future__ import annotations

import torch

from . import _build
from .base import LaneKernel
from .philox import PhiloxStream, lanes, normals


def gaussian_noise_plain(stream: PhiloxStream, B: int, n: int
                         ) -> torch.Tensor:
    """The ``(B, n)`` normals the kernel draws on ``stream``."""
    return normals(stream, lanes(stream, B), 0, n)


def _width(columns: tuple[int, int]) -> int:
    """The row width S of ``columns``, which fill it exactly."""
    used = sorted(c for c in columns if c >= 0)
    if not used or used != list(range(len(used))):
        raise ValueError(f"gaussian_simulate: columns {columns} must fill "
                         "0..S-1")
    return len(used)


def gaussian_simulate_plain(theta: torch.Tensor, *, n: int,
                            stream: PhiloxStream,
                            columns: tuple[int, int] = (0, 1)
                            ) -> torch.Tensor:
    """Plain PyTorch version: ``(B, >= 2)`` theta -> ``(B, S)`` rows, the
    mean in column ``columns[0]`` and the std in ``columns[1]``."""
    from ..models.gaussian import gaussian_sim

    _width(columns)
    out = gaussian_sim(theta, gaussian_noise_plain(stream, theta.shape[0], n))
    by_col = sorted(zip(columns, ("mean", "std")))
    return torch.stack([out[k] for c, k in by_col if c >= 0], dim=1)


class GaussianSimulate(LaneKernel):
    name = "gaussian_simulate"
    source = "pyabc_tpu_torch/csrc/gaussian.cu"
    replaces = "pyabc_tpu/models/gaussian.py:20"

    def __call__(self, theta: torch.Tensor, *, n: int, stream: PhiloxStream,
                 columns: tuple[int, int] = (0, 1)) -> torch.Tensor:
        if self.on_cpu(theta, stream.counters):
            return gaussian_simulate_plain(theta, n=n, stream=stream,
                                           columns=columns)
        S = _width(columns)
        B, stride = theta.shape
        if stride < 2 or n <= 0:
            raise ValueError(f"{self.name}: theta needs 2 columns and n > 0")
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        out = torch.empty(B, S, dtype=torch.float32, device=theta.device)
        err = _build.library().pyabc_gaussian_simulate(
            theta.data_ptr(), B, stride, int(n), *stream.key,
            stream.generation, stream.tag, stream.max_rounds,
            int(stream.lane0), stream.counters.data_ptr(), S,
            *map(int, columns), out.data_ptr(),
            _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.count_launch(stream)
        return out


gaussian_simulate = GaussianSimulate()


def mean_only_noise_plain(stream: PhiloxStream, B: int) -> torch.Tensor:
    """The ``(B,)`` normals the mean-only kernel draws on ``stream``."""
    return normals(stream, lanes(stream, B), 0, 1)[:, 0]


def mean_only_simulate_plain(theta: torch.Tensor, *, noise_sd: float,
                             stream: PhiloxStream) -> torch.Tensor:
    """Plain PyTorch version: ``(B, >= 1)`` theta -> ``(B, 1)`` rows."""
    from ..models.gaussian import mean_only_sim

    x = mean_only_sim(theta, mean_only_noise_plain(stream, theta.shape[0]),
                      noise_sd)["x"]
    return x.to(torch.float32).unsqueeze(1)


class MeanOnlySimulate(LaneKernel):
    name = "mean_only_simulate"
    source = "pyabc_tpu_torch/csrc/gaussian.cu"
    replaces = "pyabc_tpu/models/gaussian.py:38"

    def __call__(self, theta: torch.Tensor, *, noise_sd: float,
                 stream: PhiloxStream) -> torch.Tensor:
        if self.on_cpu(theta, stream.counters):
            return mean_only_simulate_plain(theta, noise_sd=noise_sd,
                                            stream=stream)
        B, stride = theta.shape
        if stride < 1:
            raise ValueError(f"{self.name}: theta needs a column")
        self.expect(theta, "theta", torch.float32, (B, stride))
        self.expect(stream.counters, "counters", torch.int32,
                    (stream.counters.shape[0],))
        out = torch.empty(B, 1, dtype=torch.float32, device=theta.device)
        err = _build.library().pyabc_mean_only_simulate(
            theta.data_ptr(), B, stride, float(noise_sd), *stream.key,
            stream.generation, stream.tag, stream.max_rounds,
            int(stream.lane0), stream.counters.data_ptr(), out.data_ptr(),
            _build.stream_ptr(theta.device))
        _build.check(err, self.name)
        self.count_launch(stream)
        return out


mean_only_simulate = MeanOnlySimulate()
