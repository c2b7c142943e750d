"""A configuration, a traffic mix and a metric dropped into a copy of the
benchmark are found by their names, with no code edited."""

from __future__ import annotations

import json

import pytest

from gpubench import harness
from gpubench.tests.conftest import make_tiny_root, run_tiny


def test_new_files_are_found_by_name(tmp_path):
    root = make_tiny_root(tmp_path, "batch-decode")  # adds configs/tiny.json, traffic/tiny.json, a cell
    (root / "gpubench/metrics/requests_counted.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "requests_counted", "unit": "requests", "better": "higher", "bound": 0.1,
                               "source": "host_clock", "workloads": ["tiny.batch-decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("tiny.batch-decode", root)
    assert cell.shapes.dim == 256 and cell.mix["block"] == 8
    res = run_tiny(root, "tiny.batch-decode")
    assert res["metrics"]["requests_counted"]["value"] == res["attempted"] > 0
    assert {"output_tok_s", "tpot_p90_ms", "setup_s"} <= set(res["metrics"])


def test_the_traced_run_on_the_cpu_writes_no_device_number(tmp_path):
    root = make_tiny_root(tmp_path, "batch-decode")
    # the profiler saw no device: the device readings have nothing to read,
    # and a metric that lists the cell fails the run rather than go missing
    with pytest.raises(harness.RunError, match=r"metric \S+\.decode has no value"):
        run_tiny(root, "tiny.batch-decode", trace=True)


def test_a_metric_without_a_value_is_left_out_only_where_it_lists_no_cell(tmp_path):
    root = make_tiny_root(tmp_path, "batch-decode")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:  # the device readings list the 8B cells, not the tiny one
        if m["name"] != "slot_util.decode":
            m["workloads"] = [w for w in m["workloads"] if w != "tiny.batch-decode"]
    spec["per_layer"].append({"name": "nothing_here", "unit": "%", "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "output_tok_s"})
    (root / "gpubench/metrics/nothing_here.py").write_text("def read(run):\n    return None\n")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run_tiny(root, "tiny.batch-decode", trace=True)
    assert set(res["metrics"]) == {"slot_util.decode"}
    assert res["busy_s"] == 0.0


def test_a_cell_without_its_files_is_refused(tmp_path):
    root = make_tiny_root(tmp_path, "batch-decode")
    (root / "gpubench/traffic/tiny.json").unlink()
    try:
        harness.load_cell("tiny.batch-decode", root)
    except (harness.RunError, FileNotFoundError):
        return
    raise AssertionError("a missing traffic file was not noticed")
