"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qwen3_rs_tpu_torch import Engine, InferenceConfig, run_inference
from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "qwen3_rs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None
sys.modules["qwen3_rs_tpu"] = None
import importlib, pkgutil
import qwen3_rs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules if sys.modules[m])
print(len(names))
"""


def test_package_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the port was imported


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax(path):
    text = path.read_text()
    assert not re.search(r"\bqwen3_rs_tpu\.", text), "names the JAX package"
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M), "imports jax"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_defaults_to_the_card(no_cuda):
    cfg = qwen3_config("0.6b", seq_len=32, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(config=cfg, weights=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        random_weights(cfg)


def test_cli_defaults_to_the_card(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_inference(InferenceConfig(str(tmp_path), mode="generate", prompt="hi"))
