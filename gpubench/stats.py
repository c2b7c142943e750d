"""Statistics over a run's requests: every request counts, a failed or
unfinished one as missing every limit (an infinite time)."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-quantile (0 < q < 1) of ``values``, linear between the two
    nearest ranks (numpy's default).  ``inf`` entries sort last; a quantile
    that reaches one is ``inf``."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    h = (len(xs) - 1) * q
    lo = math.floor(h)
    if h == lo:
        return xs[lo]
    if math.isinf(xs[lo + 1]):
        return math.inf
    return xs[lo] + (h - lo) * (xs[lo + 1] - xs[lo])
