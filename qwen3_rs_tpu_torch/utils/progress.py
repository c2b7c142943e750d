"""Console progress bar for long-running export steps."""

from __future__ import annotations

import sys
import time


class ProgressTracker:
    """A one-line ``label: [=====   ] i/n (pct%) detail`` bar on ``stream``
    (default stderr), redrawn at most every ``min_interval`` seconds."""

    def __init__(self, total: int, label: str = "Progress", stream=None, min_interval: float = 0.1):
        self.total = max(total, 1)
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval = min_interval
        self._last_render = 0.0
        self.current = 0

    def set_current(self, current: int, detail: str | None = None):
        self.current = current
        now = time.monotonic()
        if now - self._last_render < self.min_interval and current < self.total:
            return
        self._last_render = now
        pct = 100.0 * current / self.total
        bar_w = 30
        filled = int(bar_w * current / self.total)
        bar = "=" * filled + " " * (bar_w - filled)
        suffix = f" {detail}" if detail else ""
        self.stream.write(f"\r{self.label}: [{bar}] {current}/{self.total} ({pct:5.1f}%){suffix:<60.60}")
        self.stream.flush()

    def finish(self):
        self.set_current(self.total)
        self.stream.write("\n")
        self.stream.flush()
