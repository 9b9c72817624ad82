"""Summary-statistic flattening registry.

Simulators return a dict ``{name: (B, *shape) tensor}``; the device code
wants one dense ``(B, S)`` row per lane. ``SumStatSpec`` records shapes and
offsets once. The keys are SORTED, exactly as in the JAX package, so the
Lotka-Volterra layout is ``pred[0:n_obs] | prey[0:n_obs]``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


class SumStatSpec:
    def __init__(self, example: Mapping[str, object]):
        self.names: tuple[str, ...] = tuple(sorted(example.keys()))
        self.shapes: dict[str, tuple[int, ...]] = {}
        self.sizes: dict[str, int] = {}
        self.offsets: dict[str, int] = {}
        off = 0
        for n in self.names:
            shp = tuple(np.shape(example[n]))
            size = int(np.prod(shp)) if shp else 1
            self.shapes[n] = shp
            self.sizes[n] = size
            self.offsets[n] = off
            off += size
        self.total_size = off

    def flatten(self, stats: Mapping[str, torch.Tensor], batch: int
                ) -> torch.Tensor:
        """dict of ``(batch, *shape)`` tensors -> ``(batch, S)`` float32."""
        parts = [stats[n].reshape(batch, -1).to(torch.float32)
                 for n in self.names]
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]

    def flatten_host(self, stats: Mapping) -> np.ndarray:
        """One observation dict -> ``(S,)`` float64 numpy vector."""
        parts = [np.ravel(np.asarray(stats[n], np.float64))
                 for n in self.names]
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def labels(self) -> list[str]:
        """One label per flat entry: 'name' for scalars, 'name[i]' else."""
        out = []
        for n in self.names:
            if self.sizes[n] == 1 and self.shapes[n] == ():
                out.append(n)
            else:
                out.extend(f"{n}[{i}]" for i in range(self.sizes[n]))
        return out

    def __eq__(self, other):
        return (isinstance(other, SumStatSpec) and self.names == other.names
                and self.shapes == other.shapes)

    def __repr__(self):
        return f"SumStatSpec({dict(self.shapes)})"
