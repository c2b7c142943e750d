"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from gpubench import harness
from gpubench.tests.conftest import REPO


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (REPO / "gpubench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "gpubench/reference").rglob("*.py"):
        assert not any(m.split(".")[0] == "qwen3_rs_tpu_torch" for m in _imports(path)), path
    code = ("import sys; import gpubench.reference.qwen3, gpubench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'qwen3_rs_tpu_torch', 'jax', 'qwen3_rs_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_the_port_and_not_the_jax_package(tiny_batch):
    code = ("import sys, time; sys.path.insert(0, 'gpubench'); "
            "from gpubench.tests.conftest import run_tiny; from pathlib import Path; "
            f"run_tiny(Path({str(tiny_batch)!r}), 'tiny.batch-decode', seconds=0.5); "
            "from gpubench import harness; "
            "print(harness.forbidden_modules(), 'qwen3_rs_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "qwen3_rs_tpu"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "qwen3_rs_tpu_torch_extra", sys)
    assert "qwen3_rs_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qwen3_rs_tpu.sub", sys)
    assert "qwen3_rs_tpu" in harness.forbidden_modules()
