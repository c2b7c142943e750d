"""Host-side helpers of the port."""

from .compile_cache import enable_compile_cache
from .progress import ProgressTracker

__all__ = ["ProgressTracker", "enable_compile_cache"]
