"""Parameter registry (the ``pyabc_tpu.core.parameters`` counterpart): the
name <-> column map of the dense ``theta: (n, dim)`` tensors."""
from __future__ import annotations

from typing import Iterable


class ParameterSpace:
    """Registry mapping parameter names to columns of a dense theta array."""

    def __init__(self, names: Iterable[str]):
        self.names: tuple[str, ...] = tuple(names)
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate parameter names: {self.names}")

    @property
    def dim(self) -> int:
        return len(self.names)

    def __len__(self) -> int:
        return self.dim

    def __repr__(self) -> str:
        return f"ParameterSpace({list(self.names)})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ParameterSpace) and other.names == self.names

    def __hash__(self) -> int:
        return hash(self.names)
