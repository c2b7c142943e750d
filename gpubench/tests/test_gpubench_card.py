"""On the card: one short traced run of a cell through the benchmark's
command, its last line read as the result.  Skips without a card
(``python -m pytest gpubench/tests -m cuda`` on a machine with one)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gpubench.tests.conftest import REPO


@pytest.mark.cuda
def test_a_short_traced_run_gives_every_layer_reading(card):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "qwen3-4b.batch-decode",
                          "--seed", str(2**31 + 101), "--seconds", "6", "--trace", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    assert {"slot_util.decode", "mfu.decode", "device_ops_per_token.decode", "mk_roofline.decode",
            "device_idle.decode"} <= set(line["metrics"])
    assert 0 < line["metrics"]["mk_roofline.decode"]["value"] <= 100
    assert len(line["breakdown"]["device_ops"]) > 0
