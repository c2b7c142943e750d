"""The profiling helpers: ``StepTimer`` against the JAX package's on the same
samples, and ``profile_trace`` writing a ``torch.profiler`` trace under its
directory (nothing without one)."""

import json

import pytest
import torch

from qwen3_rs_tpu.utils.profiling import StepTimer as JaxStepTimer
from qwen3_rs_tpu_torch.utils.profiling import StepTimer, profile_trace

torch.set_num_threads(2)


@pytest.mark.parametrize("samples", [[], [0.004], [0.003, 0.001, 0.002, 0.010, 0.0025] * 41])
def test_step_timer_summary_matches_jax(samples):
    port, ref = StepTimer(), JaxStepTimer()
    port.samples, ref.samples = list(samples), list(samples)
    assert port.summary() == ref.summary()
    assert set(port.summary()) == ({"steps"} if not samples else {"steps", "mean_ms", "p50_ms", "p99_ms"})


def test_step_timer_times_a_step():
    t = StepTimer()
    t.stop()  # no step started: nothing recorded
    t.start()
    t.stop()
    assert len(t.samples) == 1 and t.samples[0] >= 0.0 and t.summary()["steps"] == 1


def test_profile_trace_writes_a_trace(tmp_path):
    out = tmp_path / "trace"
    with profile_trace(str(out)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(out.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_profile_trace_without_a_directory_does_nothing(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)

    def refuse(*a, **k):
        raise AssertionError("profiled without a directory")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profile_trace(log_dir):
        torch.ones(4) + 1
    assert not list(tmp_path.iterdir())
