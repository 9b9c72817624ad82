"""Acceptors (``pyabc_tpu/acceptor/acceptor.py`` counterpart).

Only the uniform acceptor is ported: its device form is the accept test of
the K5 kernel (``kernels/pnorm_accept.py``).
"""
from __future__ import annotations


class UniformAcceptor:
    """Accept iff distance <= epsilon. ``use_complete_history`` also
    requires the distance to be below every earlier threshold (the device
    carries the running minimum)."""

    def __init__(self, use_complete_history: bool = False):
        self.use_complete_history = bool(use_complete_history)

    def get_config(self) -> dict:
        return {"name": type(self).__name__}

    def __repr__(self):
        return (f"UniformAcceptor(use_complete_history="
                f"{self.use_complete_history})")
