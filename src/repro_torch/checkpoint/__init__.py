from .store import CheckpointManager
__all__ = ["CheckpointManager"]
