"""The port's public API against the JAX package's: every name in an
``__all__`` list of the JAX package exists in the port's module of the same
path, or is listed in ``qwen3_rs_tpu_torch.NOT_PORTED`` with its ROADMAP.md
item; the model registry and ``ModelConfig.architecture_name`` agree."""

import dataclasses
import importlib

import pytest

import qwen3_rs_tpu
import qwen3_rs_tpu_torch
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models import MODEL_FORWARDS, get_forward, qwen3_forward

MODULES = ["", "models", "ops", "inference", "serving", "export", "utils", "parallel"]


def _listed(*parts):
    return ".".join(p for p in parts if p) in qwen3_rs_tpu_torch.NOT_PORTED


@pytest.mark.parametrize("sub", MODULES)
def test_every_public_name_is_ported_or_listed(sub):
    suffix = "." + sub if sub else ""
    ref = importlib.import_module("qwen3_rs_tpu" + suffix)
    if _listed(sub):
        return
    port = importlib.import_module("qwen3_rs_tpu_torch" + suffix)
    names = [n for n in ref.__all__ if not _listed(sub, n)]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, f"qwen3_rs_tpu{suffix}: {missing} neither ported nor listed as not ported"
    assert set(names) <= set(port.__all__)


def _resolve(path):
    """The JAX package's object at a dotted path below it: each part an
    attribute of the one before or a module below it."""
    parts = path.split(".")
    obj = importlib.import_module("qwen3_rs_tpu." + parts[0])
    for i, part in enumerate(parts[1:], 2):
        obj = getattr(obj, part) if hasattr(obj, part) else importlib.import_module(
            "qwen3_rs_tpu." + ".".join(parts[:i]))
    return obj


def test_not_ported_names_their_roadmap_item():
    for what, item in qwen3_rs_tpu_torch.NOT_PORTED.items():
        assert item.startswith("queue 1, item "), (what, item)
        assert _resolve(what) is not None, what


@pytest.mark.parametrize("arch", [1, 2, 7])
def test_registry_and_architecture_name_match_jax(arch):
    import qwen3_rs_tpu.models as jax_models

    c = ModelConfig(architecture_id=arch, dim=64, hidden_dim=128, n_layers=1, n_heads=2, n_kv_heads=1, head_dim=32,
                    seq_len=16, vocab_size=32, group_size=32, shared_classifier=True)
    assert c.architecture_name == JaxConfig(**dataclasses.asdict(c)).architecture_name
    assert set(MODEL_FORWARDS) == set(jax_models.MODEL_FORWARDS)
    if arch in MODEL_FORWARDS:
        assert get_forward(c) is qwen3_forward
    else:
        with pytest.raises(ValueError, match="Unknown architecture_id"):
            get_forward(c)


def test_top_level_docstring_names_the_formats():
    doc = qwen3_rs_tpu_torch.__doc__
    assert "INT4" in doc and "device sampling" in doc and qwen3_rs_tpu.__all__


def test_inference_config_has_the_jax_fields_and_defaults():
    """The port's ``InferenceConfig`` is JAX's, field for field and default
    for default (the seed's default is the clock in both), plus ``device``."""
    ref = {f.name: f for f in dataclasses.fields(qwen3_rs_tpu.InferenceConfig)}
    port = {f.name: f for f in dataclasses.fields(qwen3_rs_tpu_torch.InferenceConfig)}
    assert set(port) - set(ref) == {"device"}
    assert set(ref) <= set(port)
    assert [n for n in port if n in ref] == list(ref)  # in JAX's order
    for name, f in ref.items():
        assert port[name].default == f.default, name
        assert port[name].default_factory == f.default_factory, name
    assert qwen3_rs_tpu_torch.InferenceConfig("ckpt", sp_threshold=8192).sp_threshold == 8192


def test_cli_passes_sp_threshold_to_the_config(monkeypatch):
    from qwen3_rs_tpu_torch import cli

    seen = []
    monkeypatch.setattr(qwen3_rs_tpu_torch, "run_inference", seen.append)
    for argv, want in ((["inference", "m.qtpu", "--sp-threshold", "8192"], 8192), (["inference", "m.qtpu"], 4096)):
        assert cli.main(argv + ["--device", "cpu"]) == 0
        assert seen[-1].sp_threshold == want and seen[-1].device == "cpu"


def test_rope_table_takes_the_card_by_default(monkeypatch):
    import torch

    from qwen3_rs_tpu_torch.ops.rope import rope_table

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rope_table(16, 8)
    cos, sin = rope_table(16, 8, 1e6, "cpu")
    assert cos.device.type == sin.device.type == "cpu" and cos.shape == (16, 4)
