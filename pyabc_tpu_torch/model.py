"""Device models (the ``pyabc_tpu/model.py::JaxModel`` counterpart).

A ``TorchModel`` wraps a batched simulator
``sim(theta (B, dim), generator) -> {name: (B, *shape) tensor}``; the
generation loop flattens its output in SumStatSpec's sorted key order.
Built-in models may override :meth:`simulate_flat` to produce the flat
``(B, S)`` rows directly from a kernel, drawing their noise from the
round's Philox stream (``stream``) instead of the generator. A segmented
model (``segmented=``) simulates through its segment chain.
"""
from __future__ import annotations

from typing import Callable

import torch

from .core.parameters import ParameterSpace
from .core.sumstat_spec import SumStatSpec
from .kernels.philox import generator_stream
from .ops.segment import (SegmentedSim, full_sim_from_segments,
                          index_map_for, simulate_segments_flat)


class TorchModel:
    """``segmented`` (an ``ops.segment.SegmentedSim``) declares the
    segmented-simulation protocol, which makes the model eligible for
    segmented early reject; ``sim`` may then be None, the simulator being
    the segment chain (``full_sim_from_segments``), so the classic path and
    the segmented round run the same per-segment step. A user's segments
    step in torch; the built-in ones (``models.gillespie``,
    ``models.sir.make_network_sir_model``) name their CUDA kernels."""

    def __init__(self, sim: Callable | None,
                 space: ParameterSpace | list[str],
                 name: str = "torch_model", segmented=None):
        if not isinstance(space, ParameterSpace):
            space = ParameterSpace(space)
        if sim is None:
            if segmented is None:
                raise ValueError("TorchModel needs sim or segmented")
            sim = full_sim_from_segments(segmented)
        self.sim = sim
        self.space = space
        self.name = name
        #: optional segmented-simulation protocol (early reject)
        self.segmented = segmented
        self._imaps: dict = {}

    def index_map(self, spec: SumStatSpec, device,
                  seg: SegmentedSim | None = None) -> torch.Tensor:
        """The int32 ``(n_segments, seg_size)`` emission map of ``seg``
        (default: the model's protocol) onto ``spec``'s flat rows, built
        once per spec and device."""
        seg = self.segmented if seg is None else seg
        key = (id(seg), spec.names, tuple(spec.sizes.values()), str(device))
        if key not in self._imaps:
            self._imaps[key] = torch.as_tensor(index_map_for(seg, spec),
                                               device=device)
        return self._imaps[key]

    def simulate_flat(self, theta: torch.Tensor, generator: torch.Generator,
                      spec: SumStatSpec, stream=None) -> torch.Tensor:
        """``(B, dim)`` parameters -> ``(B, S)`` flat sum stats. A user
        simulator draws from ``generator``; ``stream`` (the round's
        ``PhiloxStream`` for the simulator noise) is for built-in models
        and segment chains."""
        if self.segmented is not None:
            return self._simulate_chain(self.segmented, theta, generator,
                                        spec, stream)
        out = self.sim(theta, generator)
        missing = set(spec.names) - set(out)
        if missing:
            raise KeyError(f"{self.name}: simulator output lacks "
                           f"{sorted(missing)} of the observed data")
        return spec.flatten(out, theta.shape[0])

    def _simulate_chain(self, seg, theta, generator, spec, stream):
        if stream is None:
            stream = generator_stream(generator, theta.device)
        return simulate_segments_flat(
            seg, theta, self.index_map(spec, theta.device, seg),
            spec.total_size, stream)

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class ChainModel(TorchModel):
    """A built-in model whose simulator is a chain of segments run by its
    kernel (``chain.kernel``); ``segmented`` is set only when the
    constructor was asked for segments (early reject), else the chain is
    one segment and serves the classic path alone."""

    def __init__(self, chain: SegmentedSim, space, name: str,
                 segmented: bool):
        super().__init__(full_sim_from_segments(chain), space, name,
                         segmented=chain if segmented else None)
        self.chain = chain

    def simulate_flat(self, theta, generator, spec, stream=None):
        return self._simulate_chain(self.chain, theta, generator, spec,
                                    stream)


def simulate_models_flat(models, theta: torch.Tensor, m: torch.Tensor,
                         generator: torch.Generator, spec: SumStatSpec,
                         stream=None) -> torch.Tensor:
    """K > 1: ``(B, d_max)`` parameters and each lane's model ``m (B,)``
    -> ``(B, S)`` flat sum stats with no host read. The models of one
    built-in family (``family.simulate_flat`` takes ``m``) go through the
    family's kernel in one launch; otherwise each model simulates every
    lane on its first ``dim`` parameters and each lane keeps its own
    model's row (``torch.where``), as ``lax.switch`` under ``vmap`` does."""
    family = getattr(models[0], "family", None)
    if family is not None and all(
            getattr(x, "family", None) is family
            and getattr(x, "index", None) == k for k, x in enumerate(models)):
        return family.simulate_flat(theta, m, generator, spec, stream)
    out = None
    for k, model in enumerate(models):
        rows = model.simulate_flat(theta[:, :model.space.dim].contiguous(),
                                   generator, spec, stream=stream)
        out = rows if out is None else torch.where((m == k)[:, None], rows,
                                                   out)
    return out
