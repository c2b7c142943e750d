"""Arithmetic the metric readers share (``metrics/<name>.py``).  Each
returns None where the run has nothing to read, and a share in percent; a
roofline raises ``RunError`` where its kernel ran out of its readers' sight."""

from __future__ import annotations

import math

from . import counts
from .harness import RunError
from .stats import percentile


def ttft_ms(run, q: float) -> float:
    """The q-quantile of first token less due time over the counted
    requests; one that failed or did not finish is infinite."""
    return 1e3 * percentile([r.first - r.due if r.finished and r.first is not None else math.inf
                             for r in run.requests], q)


def tpot_ms(run, q: float) -> float:
    """The q-quantile over the counted requests of (last − first token) /
    (tokens − 1); one that failed or did not finish is infinite."""
    return 1e3 * percentile([(r.last - r.first) / (len(r.served) - 1) if r.finished and len(r.served) > 1
                             else math.inf for r in run.requests], q)


def mfu(run) -> float | None:
    """The traced window's model work at the card's peak, as a share of the
    window: each forward call's least time (``counts``) summed over the
    window's seconds."""
    if run.trace is None or run.peak is None:
        return None
    c, least = run.cell.shapes, 0.0
    for call in run.calls:
        if call["kind"] == "prefill":
            least += sum(counts.prefill_least_s(c, r, run.peak) for r in call["rows"])
        elif call["kind"] == "decode_step" or (call["kind"] == "megakernel" and call["positions"] is not None):
            if call["positions"]:
                least += counts.decode_step_least_s(c, call["positions"], run.peak)
    return 100.0 * least / run.trace.window_s if least else None


def device_idle(run) -> float | None:
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.idle_share


def span_roofline(run, bounds: dict, kernels: tuple) -> float | None:
    """Σ least time of the recorded calls of the spans in ``bounds`` (span
    → least seconds of one call record) over the device time the trace
    gives those spans; None unless every span with calls has device time
    and every call a bound.  Every device operation whose name holds one of
    ``kernels`` has to have been launched inside one of those spans: one
    launched elsewhere ran through a call path that the driver does not
    wrap, and its calls would be missing from the sum."""
    if run.trace is None or run.peak is None:
        return None
    stray = {name: {str(span): n for span, n in where.items() if span not in bounds}
             for name, where in run.trace.spans_of.items() if any(k in name for k in kernels)}
    stray = {name: where for name, where in stray.items() if where}
    if stray:
        raise RunError(f"kernels launched outside the spans {sorted(bounds)}: {stray}")
    least = dev = 0.0
    for span, bound in bounds.items():
        calls = [k for k in run.calls if k.get("span") == span]
        if not calls:
            continue
        got = run.trace.by_span.get(span)
        if not got or got[1] < len(calls):
            return None
        b = [bound(k) for k in calls]
        if None in b:
            return None
        least += sum(b)
        dev += got[0]
    return 100.0 * least / dev if dev else None
