"""The port's public API against the JAX package's: every name in an
``__all__`` list of the JAX package, and every public function and class
defined in a module of the JAX package outside ``ops/pallas``, exists in the
port's module of the same path, or is listed in
``qwen3_rs_tpu_torch.NOT_PORTED`` with its ROADMAP.md item (the list is
empty: the port has every name); the model registry and
``ModelConfig.architecture_name`` agree."""

import dataclasses
import importlib
import inspect
import pkgutil

import pytest
import torch

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


# The port's own names for functions whose JAX names say "JAX" or "XLA".
PORT_NAMES = {"argmax_last_jax": "argmax_last", "gqa_attention_xla": "gqa_attention",
              "sample_tokens_jax": "sample_tokens"}
JAX_MODULES = sorted(m.name.removeprefix("qwen3_rs_tpu.")
                     for m in pkgutil.walk_packages(qwen3_rs_tpu.__path__, "qwen3_rs_tpu.")
                     if not m.name.startswith("qwen3_rs_tpu.ops.pallas"))


def _defined_here(mod) -> list[str]:
    """The public functions and classes that ``mod`` defines (not imports)."""
    return sorted(n for n, o in vars(mod).items() if not n.startswith("_")
                  and (inspect.isfunction(o) or inspect.isclass(o)) and o.__module__ == mod.__name__)


def test_not_ported_is_empty():
    assert qwen3_rs_tpu_torch.NOT_PORTED == {}


@pytest.mark.parametrize("path", JAX_MODULES)
def test_every_function_and_class_of_each_jax_module_is_ported(path):
    ref = importlib.import_module("qwen3_rs_tpu." + path)
    if _listed(path):
        return
    names = [n for n in _defined_here(ref) if not _listed(path, n)]
    port = importlib.import_module("qwen3_rs_tpu_torch." + path)  # the module itself, names or not
    missing = [n for n in names if not hasattr(port, PORT_NAMES.get(n, n))]
    assert not missing, f"qwen3_rs_tpu.{path}: {missing} neither ported nor listed as not ported"


def test_jax_module_walk_sees_the_package():
    assert {"parallel.distributed", "utils.native", "utils.compile_cache", "testing", "ops.matmul"} <= set(JAX_MODULES)
    assert not any(m.startswith("ops.pallas") for m in JAX_MODULES)


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


@pytest.mark.parametrize("name", ["0.6b", "8b"])
def test_prefill_flops_matches_jax(name):
    import qwen3_rs_tpu.testing as jax_testing
    from qwen3_rs_tpu_torch import testing

    cfg = testing.qwen3_config(name, seq_len=4096)
    jcfg = jax_testing.qwen3_config(name, seq_len=4096)
    for s, batch in ((1, 1), (512, 1), (4096, 4)):
        assert testing.prefill_flops(cfg, s, batch) == jax_testing.prefill_flops(jcfg, s, batch)


def test_transpose_quantized_matches_jax():
    import numpy as np

    import qwen3_rs_tpu.ops.matmul as jax_matmul
    from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
    from qwen3_rs_tpu_torch.ops.matmul import transpose_quantized
    from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor

    rng = np.random.default_rng(0)
    q, s = rng.integers(-128, 128, (48, 64)).astype(np.int8), rng.random((48, 4)).astype(np.float32)
    want = jax_matmul.transpose_quantized(JaxQT(q, s))
    got = transpose_quantized(QuantizedTensor(torch.from_numpy(q), torch.from_numpy(s)))
    assert got.q.shape == (64, 48) and got.scales.shape == (4, 48)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_exact_float_products_leaves_every_flag_as_it_found_it():
    from qwen3_rs_tpu_torch.ops.matmul import exact_float_products

    m = torch.backends.cuda.matmul

    def flags():
        return m.allow_tf32, m.allow_bf16_reduced_precision_reduction, getattr(m, "fp32_precision", None)

    before = flags()
    with exact_float_products():
        assert not m.allow_tf32 and not m.allow_bf16_reduced_precision_reduction
    assert flags() == before
