from .sync import SyncLedger

__all__ = ["SyncLedger"]
