"""Device models (the ``pyabc_tpu/model.py::JaxModel`` counterpart).

A ``TorchModel`` wraps a batched simulator
``sim(theta (B, dim), generator) -> {name: (B, *shape) tensor}``; the
generation loop flattens its output in SumStatSpec's sorted key order.
Built-in models may override :meth:`simulate_flat` to produce the flat
``(B, S)`` rows directly from a kernel, drawing their noise from the
round's Philox stream (``stream``) instead of the generator.
"""
from __future__ import annotations

from typing import Callable

import torch

from .core.parameters import ParameterSpace
from .core.sumstat_spec import SumStatSpec


class TorchModel:
    def __init__(self, sim: Callable, space: ParameterSpace | list[str],
                 name: str = "torch_model"):
        if not isinstance(space, ParameterSpace):
            space = ParameterSpace(space)
        self.sim = sim
        self.space = space
        self.name = name

    def simulate_flat(self, theta: torch.Tensor, generator: torch.Generator,
                      spec: SumStatSpec, stream=None) -> torch.Tensor:
        """``(B, dim)`` parameters -> ``(B, S)`` flat sum stats. A user
        simulator draws from ``generator``; ``stream`` (the round's
        ``PhiloxStream`` for the simulator noise) is for built-in models."""
        out = self.sim(theta, generator)
        missing = set(spec.names) - set(out)
        if missing:
            raise KeyError(f"{self.name}: simulator output lacks "
                           f"{sorted(missing)} of the observed data")
        return spec.flatten(out, theta.shape[0])

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


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
