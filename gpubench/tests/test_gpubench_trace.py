"""The trace reduction, on a trace written by hand in the profiler's
Chrome format."""

from __future__ import annotations

import pytest

from gpubench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


TRACE = {"traceEvents": [
    _x("user_annotation", "gpubench.step", 0, 1000),
    _x("user_annotation", "kernel.rows", 10, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
    _x("user_annotation", "kernel.rows", 40, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 45, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 2, correlation=3),
    _x("user_annotation", "scheduler.read_chunk", 500, 400),
    _x("kernel", "w8a16_tc_kernel", 100, 100, correlation=1),
    _x("kernel", "w8a16_tc_kernel", 150, 100, correlation=2),  # overlaps the first
    _x("gpu_memcpy", "Memcpy DtoH", 260, 40, correlation=3),
    _x("kernel", "orphan", 800, 50),
    _x("user_annotation", "other.thing", 0, 5000),  # not a harness span
]}


def test_busy_union_ops_and_names():
    s = trace.reduce(TRACE, window_s=1e-3)
    assert s.busy_s == pytest.approx((250 - 100 + 40 + 50) * 1e-6)
    assert s.device_ops == 4
    assert s.by_name["w8a16_tc_kernel"] == [pytest.approx(200e-6), 2]
    assert s.idle_share == pytest.approx(1 - 240e-6 / 1e-3)


def test_each_device_op_goes_to_the_innermost_span_around_its_launch():
    s = trace.reduce(TRACE, window_s=1e-3)
    assert s.by_span["kernel.rows"] == [pytest.approx(200e-6), 2]
    assert s.by_span["gpubench.step"] == [pytest.approx(40e-6), 1]  # the copy launched between the two
    assert s.attributed == 3


def test_gaps_are_named_by_what_the_host_was_doing():
    s = trace.reduce(TRACE, window_s=1e-3)
    assert s.gaps[0] == (pytest.approx(500e-6), "scheduler.read_chunk")  # 300 to 800, middle 550
    assert s.gaps[1] == (pytest.approx(10e-6), "gpubench.step")
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["w8a16_tc_kernel", pytest.approx(200e-6)]
    assert len(b["idle_gaps"]) == 2


def test_only_the_window_span_counts_when_the_trace_has_one():
    events = TRACE["traceEvents"] + [_x("user_annotation", "gpubench.window", 90, 600),
                                     _x("kernel", "before", 20, 30), _x("kernel", "after", 900, 30)]
    s = trace.reduce({"traceEvents": events}, window_s=1.0)
    assert s.window_s == pytest.approx(600e-6)
    assert s.device_ops == 3  # the two kernels and the copy that start inside it
    assert "before" not in s.by_name and "after" not in s.by_name and "orphan" not in s.by_name
    assert s.busy_s == pytest.approx((250 - 100 + 40) * 1e-6)


def test_each_op_name_keeps_the_spans_it_was_launched_in():
    s = trace.reduce(TRACE, window_s=1e-3)
    assert s.spans_of["w8a16_tc_kernel"] == {"kernel.rows": 2}
    assert s.spans_of["orphan"] == {None: 1}


def test_a_roofline_whose_kernel_ran_outside_its_spans_fails_the_run():
    import types

    from gpubench import harness, readers

    s = trace.reduce(TRACE, window_s=1e-3)
    run = types.SimpleNamespace(trace=s, peak={"hbm_bytes_per_s": 1.0}, calls=[{"span": "kernel.rows"}] * 2)
    assert readers.span_roofline(run, {"kernel.rows": lambda call: 50e-6}, ("w8a16_tc",)) == pytest.approx(50.0)
    with pytest.raises(harness.RunError, match="orphan"):
        readers.span_roofline(run, {"kernel.rows": lambda call: 50e-6}, ("w8a16_tc", "orphan"))
