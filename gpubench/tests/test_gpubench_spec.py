"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units, bounds, and the files each entry names."""

from __future__ import annotations

import json
import re

import pytest

from gpubench import harness
from gpubench.tests.conftest import REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"] and SPEC["command"] == ["python3", "-m", "gpubench.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_name_and_unit_uses_only_the_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[k]]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({e["name"] for k in ("end_to_end", "per_layer") for e in SPEC[k]}) == \
        len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in SPEC[k])
    texts = [w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
    texts += [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    assert all(TEXT.match(t) for t in texts)


def test_entries_have_just_their_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in SPEC["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in SPEC["workloads"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"} for m in SPEC["end_to_end"])
    assert all(set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
               for m in SPEC["per_layer"])


def test_metrics_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    assert all(m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
               for m in SPEC["per_layer"])
    assert all(m["better"] in ("lower", "higher") for k in ("end_to_end", "per_layer") for m in SPEC[k])
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in harness.selected(SPEC["end_to_end"], w["name"])]
        layer = harness.selected(SPEC["per_layer"], w["name"], set(e2e))
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
        assert w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = harness.load_cell(cell, REPO)
    assert c.check["limit_gap_sd"] > 0 and c.check["sample_tokens"] >= c.check["min_tokens"]
    assert all(callable(m["reader"].read) for m in c.end_to_end + c.per_layer)


def test_configs_are_used_and_hold_their_published_keys():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used and c["file"].startswith("gpubench/")
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["source"].startswith(c["source"])
        assert not c["reduced"]  # every published size is run as published
