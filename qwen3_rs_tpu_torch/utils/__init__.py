"""Host-side helpers of the port."""

from .progress import ProgressTracker

__all__ = ["ProgressTracker"]
