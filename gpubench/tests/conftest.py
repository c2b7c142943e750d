"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with a
tiny configuration, run on the CPU through the harness (the look for a card
is ``run.py``'s and is skipped)."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# Qwen3's structure at a size the CPU runs in seconds (the megakernel's gate
# refuses it, so decode takes the per-layer path; the kernels' plain versions).
TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, vocab_size=512)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's kernels have no CPU mode")
    return "cuda:0"


def make_tiny_root(tmp: Path, traffic_name: str = "batch-decode", tied: bool = False) -> Path:
    """A copy of ``BENCHMARK.json`` and ``gpubench/`` under ``tmp`` with the
    cell ``tiny.<traffic_name>``: the tiny configuration under a cut-down copy
    of the mix, its check that of ``qwen3-8b.<traffic_name>``."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "gpubench", root / "gpubench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "gpubench/configs/qwen3-8b.json").read_text())
    conf.update(TINY, tie_word_embeddings=tied)
    conf["assumed"]["ctx_per_slot"] = 256
    (root / "gpubench/configs/tiny.json").write_text(json.dumps(conf))
    mix = json.loads((REPO / f"gpubench/traffic/{traffic_name}.json").read_text())
    mix["prompt_tokens"].update(median=40, min=8, max=150)
    mix["output_tokens"].update(median=20, min=8, max=100)
    mix["block"] = 8
    if mix["loop"]["kind"] == "open":
        mix["loop"].update(rate_per_s=20.0, preroll_s=0.5)
    (root / "gpubench/traffic/tiny.json").write_text(json.dumps(mix))
    cell = f"tiny.{traffic_name}"
    spec["configs"].append({"name": "tiny", "source": "https://huggingface.co/Qwen/Qwen3-8B",
                            "file": "gpubench/configs/tiny.json", "reduced": list(TINY), "why": "CPU tests"})
    spec["workloads"].append({"name": cell, "config": "tiny", "traffic": "tiny", "chips": 1, "why": "CPU tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and f"qwen3-8b.{traffic_name}" in m["workloads"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copy(REPO / f"gpubench/checks/qwen3-8b.{traffic_name}.json", root / f"gpubench/checks/{cell}.json")
    return root


def run_tiny(root: Path, cell: str, seed: int = 2**31 + 17, seconds: float = 3.0, trace: bool = False) -> dict:
    import torch

    from gpubench import harness

    torch.manual_seed(0)
    torch.set_num_threads(2)  # several test workers share the cores
    c = harness.load_cell(cell, root)
    c.check["min_tokens"] = 20
    return harness.execute(c, seed, seconds, trace, "cpu", time.perf_counter(), log=lambda m: None)


@pytest.fixture
def tiny_batch(tmp_path):
    return make_tiny_root(tmp_path, "batch-decode")
