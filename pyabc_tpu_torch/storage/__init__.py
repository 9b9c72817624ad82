from .history import History

__all__ = ["History"]
