"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qwen3_rs_tpu_torch import Engine, InferenceConfig, evaluate_checkpoint, run_inference
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.testing import qwen3_config, random_weights

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "qwen3_rs_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_IMPORT_ALL = """
import ctypes, sys
sys.modules["jax"] = None
sys.modules["qwen3_rs_tpu"] = None
_load = ctypes.CDLL
def _refuse_host_lib(name, *a, **k):
    assert "libqwen3_host" not in str(name), name
    return _load(name, *a, **k)
ctypes.CDLL = _refuse_host_lib
import importlib, pkgutil
import qwen3_rs_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules if sys.modules[m])
print(" ".join(names))
"""


def test_package_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 30  # every module of the port was imported, the serving slice's too
    assert {f"qwen3_rs_tpu_torch.serving.{m}" for m in ("paged_cache", "scheduler", "server")} <= names
    assert "qwen3_rs_tpu_torch.ops.kernels.paged_attention" in names
    export = ("tensor_reader", "config_loader", "architectures", "lora", "model_exporter", "tokenizer_exporter",
              "chat_template_exporter")  # the exporter: numpy and JSON, no JAX helper either
    assert {f"qwen3_rs_tpu_torch.export.{m}" for m in export} | {"qwen3_rs_tpu_torch.utils.progress"} <= names
    parallel = ("mesh", "sharding", "distributed", "tp", "pipeline", "context")  # ranks are processes of their own
    assert {f"qwen3_rs_tpu_torch.parallel.{m}" for m in parallel} | {"qwen3_rs_tpu_torch.ops.collectives"} <= names
    assert {"qwen3_rs_tpu_torch.serving.remote", "qwen3_rs_tpu_torch.utils.profiling"} <= names
    probes = ("boundary_probe", "hbm_stream_bench", "head_a8_probe", "a8_depth_probe")  # importing one runs nothing
    assert {f"qwen3_rs_tpu_torch.scripts.{m}" for m in probes} | {"qwen3_rs_tpu_torch.ops.kernels.probes"} <= names


_TP_RANKS = """
import functools
from qwen3_rs_tpu_torch.serving import Request
from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine
from qwen3_rs_tpu_torch.testing import random_model
from qwen3_rs_tpu_torch.configuration import ModelConfig

if __name__ == "__main__":
    cfg = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
                      head_dim=128, seq_len=64, vocab_size=256, group_size=64, shared_classifier=True)
    engine = start_tp_engine(functools.partial(random_model, cfg, seed=1, device="cpu"), ["cpu", "cpu"],
                             n_slots=2, kv_layout="paged", page_size=16, sampling="device")
    engine.submit(Request(0, [3, 4, 5], max_new_tokens=3))
    done = engine.run()
    reports = engine.rank_reports()
    engine.close()
    assert len(done[0].generated) == 3 and reports[0]["streams"] == reports[1]["streams"]
    print("ranks ok")
"""


def test_spawned_ranks_import_no_jax(tmp_path):
    """A tensor-parallel engine's ranks, spawned processes of their own, run
    with JAX and the JAX package made unimportable: a fake ``jax`` and
    ``qwen3_rs_tpu`` that raise come first on every rank's path."""
    for name in ("jax", "qwen3_rs_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('{name} imported by the port')\n")
    script = tmp_path / "ranks.py"
    script.write_text(_TP_RANKS)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "ranks ok" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax(path):
    text = path.read_text()
    assert not re.search(r"\bqwen3_rs_tpu\.", text), "names the JAX package"
    assert not re.search(r"^\s*(import jax|from jax)", text, re.M), "imports jax"
    # Nor the JAX package's native host helper: its library, or the repo
    # root's csrc/ that builds it (the port builds its own copy of the sources).
    assert not re.search(r"libqwen3_host|csrc/build\.py", text), "uses the JAX package's native helper"


_LOAD_HOST_HELPER = """
import numpy as np
from qwen3_rs_tpu_torch.ops.kernels import build
from qwen3_rs_tpu_torch.utils import native
assert native.load_library() is not None
assert (native.native_transpose(np.eye(3, dtype=np.int8)) == np.eye(3)).all()
maps = open("/proc/self/maps").read()
assert "libqwen3_host" not in maps
assert str(native.lib_path()) in maps and native.lib_path().parent == build.BUILD_DIR
print(native.CSRC, build.CSRC)
"""


def test_host_helper_is_the_ports_own():
    """The port's host helper builds from the port's sources into the port's
    build directory, and the process that loads it maps no JAX helper."""
    out = subprocess.run([sys.executable, "-c", _LOAD_HOST_HELPER], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    port_csrc = str(ROOT / "qwen3_rs_tpu_torch" / "csrc")
    assert out.stdout.split() == [port_csrc, port_csrc]


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


def test_exact_engine_defaults_to_the_card(no_cuda):
    cfg = qwen3_config("0.6b", seq_len=32, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(config=cfg, weights=None, mode="exact")


def test_eval_ppl_defaults_to_the_card(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_checkpoint(tmp_path, token_ids=[1, 2, 3])
    text = tmp_path / "t.txt"
    text.write_text("hello")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["eval-ppl", str(tmp_path), "-f", str(text)])
