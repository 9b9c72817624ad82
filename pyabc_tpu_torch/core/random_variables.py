"""Random variables and priors on batched torch tensors.

The ``pyabc_tpu.core.random_variables`` counterpart for the families the
main path uses: ``RV("norm", loc, scale)`` and ``RV("uniform", loc,
scale)`` in scipy's loc/scale convention. ``Distribution.rvs_array`` and
``logpdf_array`` are the batched twins of the JAX per-lane functions:
one ``(B, dim)`` draw per call from an explicit ``torch.Generator`` (the
CPU and the tests). On the run's path the K2 kernel draws and scores the
prior itself, from the per-dimension arrays of ``Distribution.arrays``.
"""
from __future__ import annotations

import math

import torch

from .parameters import ParameterSpace

_LOG_2PI = math.log(2.0 * math.pi)

#: families with a batched torch sampler and log-density; the index is
#: the family code K2 reads (``Distribution.arrays``)
FAMILIES = ("norm", "uniform")


class RV:
    """``RV("norm" | "uniform", loc=0, scale=1)``."""

    def __init__(self, name: str, loc: float = 0.0, scale: float = 1.0):
        if name not in FAMILIES:
            raise NotImplementedError(
                f"RV family {name!r} is not ported yet (ROADMAP queue A, "
                f"item 12: the rest of the strategy layer); supported: "
                f"{list(FAMILIES)}"
            )
        self.name = name
        self.loc = float(loc)
        self.scale = float(scale)

    def rvs(self, n: int, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
        if self.name == "norm":
            z = torch.randn(n, generator=generator, device=device)
        else:
            z = torch.rand(n, generator=generator, device=device)
        return self.loc + self.scale * z

    def logpdf(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "norm":
            z = (x - self.loc) / self.scale
            return -0.5 * (z * z + _LOG_2PI) - math.log(self.scale)
        inside = (x >= self.loc) & (x <= self.loc + self.scale)
        return torch.where(
            inside, torch.full_like(x, -math.log(self.scale)),
            torch.full_like(x, -math.inf),
        )

    def __repr__(self) -> str:
        return f"RV({self.name!r}, {self.loc!r}, {self.scale!r})"


class Distribution:
    """A named product prior, ``Distribution(a=RV(...), b=RV(...))``.

    Columns follow insertion order (``self.space.names``)."""

    def __init__(self, **rvs: RV):
        if not rvs:
            raise ValueError("Distribution needs at least one RV")
        for k, rv in rvs.items():
            if not isinstance(rv, RV):
                raise NotImplementedError(
                    f"prior component {k!r} is {type(rv).__name__}; only "
                    f"RV('norm'|'uniform') is ported (ROADMAP queue A, "
                    f"item 12)"
                )
        self.rv_map: dict[str, RV] = dict(rvs)
        self.space = ParameterSpace(self.rv_map.keys())

    @classmethod
    def from_spec(cls, spec) -> "Distribution":
        """Build from ``[(name, "norm"|"uniform", loc, scale), ...]``."""
        return cls(**{name: RV(kind, loc, scale)
                      for name, kind, loc, scale in spec})

    @property
    def dim(self) -> int:
        return self.space.dim

    def rvs_array(self, n: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
        """``(n, dim)`` float32 draw, one column per component."""
        cols = [rv.rvs(n, generator, device) for rv in self.rv_map.values()]
        return torch.stack(cols, dim=1).to(torch.float32)

    def logpdf_array(self, theta: torch.Tensor) -> torch.Tensor:
        """Log density of ``(..., >= dim)`` thetas; only the first ``dim``
        columns are read, so padded thetas are fine."""
        parts = [rv.logpdf(theta[..., i])
                 for i, rv in enumerate(self.rv_map.values())]
        return sum(parts[1:], parts[0])

    def arrays(self, device) -> dict:
        """Per-dimension float32/int32 device arrays of the prior, built
        once per run for the K2 kernel: ``kind`` (index in FAMILIES),
        ``loc``, ``scale``, ``hi = loc + scale`` (the uniform's upper
        edge) and ``log_scale``."""
        rvs = list(self.rv_map.values())

        def f32(vals):
            return torch.tensor(vals, dtype=torch.float32, device=device)

        return {
            "kind": torch.tensor([FAMILIES.index(rv.name) for rv in rvs],
                                 dtype=torch.int32, device=device),
            "loc": f32([rv.loc for rv in rvs]),
            "scale": f32([rv.scale for rv in rvs]),
            "hi": f32([rv.loc + rv.scale for rv in rvs]),
            "log_scale": f32([math.log(rv.scale) for rv in rvs]),
        }

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self.rv_map.items())
        return f"Distribution({inner})"


def stacked_arrays(priors, device) -> dict:
    """The per-model priors of a run over several models as ``(K, d_max)``
    arrays for K2 (``Distribution.arrays`` of each, zero-padded past its
    dim) and ``dims (K,)`` int32: model m's prior log-density runs over
    its first ``dims[m]`` entries only."""
    parts = [p.arrays("cpu") for p in priors]
    d_max = max(p.dim for p in priors)

    def pad(key):
        rows = [torch.nn.functional.pad(a[key], (0, d_max - a[key].shape[0]))
                for a in parts]
        return torch.stack(rows).contiguous().to(device)

    out = {k: pad(k) for k in ("kind", "loc", "scale", "hi", "log_scale")}
    out["dims"] = torch.tensor([p.dim for p in priors], dtype=torch.int32,
                               device=device)
    return out
