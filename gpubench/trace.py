"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

The traced run wraps the calls into each layer in ``record_function`` spans
(a driver's ``Recorder``) and the measured window in the span
``gpubench.window``, to which the reduction keeps.  The profiler's Chrome trace is written under
``TMPDIR``, read once and deleted.  From it:

* the device operations (kernels, copies, fills), their busy time (the union
  of their intervals), their count and their time by name;
* each device operation's span: the innermost harness span around the host
  call that launched it (the launch is found by its correlation id);
* the idle gaps between device operations inside the window, each named by
  the innermost span the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIXES = ("gpubench.", "scheduler.", "model.", "kernel.")  # the harness's spans
WINDOW = "gpubench.window"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    by_name: dict  # name -> [seconds, count]
    by_span: dict  # span -> [seconds, count] of the device operations it launched
    spans_of: dict  # name -> {span (None: no harness span) -> count}
    gaps: list  # [(seconds, label)], longest first
    attributed: int  # device operations whose launch was found

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def capture(prof) -> dict:
    """The profiler's trace as a dict, through a file under ``TMPDIR``."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


class _Spans:
    """Properly nested host spans, sorted by start, each with its parent."""

    def __init__(self, ann: list):
        self.starts = [e["ts"] for e in ann]
        self.ends = [e["ts"] + e["dur"] for e in ann]
        self.names = [e["name"] for e in ann]
        self.parents = []
        stack: list = []
        for i, s in enumerate(self.starts):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            self.parents.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float):
        """The name of the innermost span that covers ``t``, or None: the
        latest span started by ``t``, or the first of its ancestors that has
        not ended."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] <= t:
            j = self.parents[j]
        return self.names[j] if j >= 0 else None


def reduce(trace: dict, window_s: float) -> Summary:
    """The trace's numbers over the span ``WINDOW`` (its device operations
    that start inside it; its length is the window's), or over the whole
    trace and ``window_s`` where the trace has no such span."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if marks:
        w0, w1 = marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]
        dev = [e for e in dev if w0 <= e["ts"] < w1]
        window_s = (w1 - w0) * 1e-6
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ann = sorted((e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIXES)),
                 key=lambda e: e["ts"])
    spans = _Spans(ann)

    by_name: dict = {}
    by_span: dict = {}
    spans_of: dict = {}
    attributed = 0
    busy = 0.0
    gaps = []
    end = None
    for e in dev:
        s, d = e["ts"], e["dur"]
        name = e["name"]
        by_name.setdefault(name, [0.0, 0])
        by_name[name][0] += d * 1e-6
        by_name[name][1] += 1
        corr = e.get("args", {}).get("correlation")
        span = None
        if corr in launches:
            attributed += 1
            span = spans.innermost(launches[corr])
            if span is not None:
                by_span.setdefault(span, [0.0, 0])
                by_span[span][0] += d * 1e-6
                by_span[span][1] += 1
        where = spans_of.setdefault(name, {})
        where[span] = where.get(span, 0) + 1
        if end is None or s >= end:
            if end is not None and s > end:
                gaps.append((end, s))
            busy += d
            end = s + d
        elif s + d > end:
            busy += s + d - end
            end = s + d
    named = []
    for a, b in gaps:
        label = spans.innermost((a + b) / 2) or "outside the harness spans"
        named.append(((b - a) * 1e-6, label))
    named.sort(key=lambda g: -g[0])
    return Summary(window_s=window_s, busy_s=busy * 1e-6, device_ops=len(dev), by_name=by_name,
                   by_span=by_span, spans_of=spans_of, gaps=named, attributed=attributed)


def breakdown(s: Summary, n: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took the
    most time, and the longest idle gaps by what the host was doing."""
    top = sorted(s.by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return {"device_ops": [[name[:200], sec] for name, (sec, _) in top],
            "idle_gaps": [[label, sec] for sec, label in s.gaps[:n]]}
