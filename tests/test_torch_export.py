"""The port's exporter (``qwen3_rs_tpu_torch.export``, numpy and JSON code)
against the JAX package's: the same synthetic HF model directories go through
both, and every artifact must be byte for byte the same: each file of the
native ``.qtpu`` directory (``config.json``, ``weights/*.npy``, ``_layout``,
``tokenizer.bin``, ``template*``), and the legacy ``.bin``, ``.tokenizer`` and
``.template*``.  So must the per-tensor error reports and the errors raised.
Cases: INT8 native and legacy, INT4 native, a BF16 model in two shards with
its own classifier, a LoRA fine-tune, a requested group size that the
auto-fix changes, a Llama model, a model without a chat template; INT4
legacy is refused by both.  The port's CLI ``export`` writes the API's bytes.
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from utils import TINY_CONFIG, make_hf_model_dir

from qwen3_rs_tpu.export import export_model as jax_export
from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.export import export_model, find_optimal_group_size
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor

torch.set_num_threads(2)


def _lora_tensors(rng, c, rank=4):
    out = {}
    for layer in range(c.n_layers):
        for comp, (o, i) in (("self_attn.q_proj", (c.all_heads_dim, c.dim)), ("mlp.down_proj", (c.dim, c.hidden_dim))):
            pre = f"base_model.model.model.layers.{layer}.{comp}"
            out[f"{pre}.lora_A.weight"] = rng.normal(0, 0.05, (rank, i)).astype(np.float32)
            out[f"{pre}.lora_B.weight"] = rng.normal(0, 0.05, (o, rank)).astype(np.float32)
    return out


SEEDS = {"base": 1, "bf16-shards-own-head": 2, "lora": 3, "llama-no-template": 4}


def _model(tmp: Path, kind: str) -> Path:
    rng = np.random.default_rng(SEEDS[kind])
    if kind == "base":
        return make_hf_model_dir(tmp, rng=rng)
    if kind == "bf16-shards-own-head":
        return make_hf_model_dir(tmp, rng=rng, dtype="BF16", n_shards=2, shared_classifier=False)
    if kind == "lora":
        lora = {"config": {"lora_alpha": 16.0, "r": 4, "target_modules": ["q_proj", "down_proj"]},
                "tensors": _lora_tensors(rng, TINY_CONFIG)}
        return make_hf_model_dir(tmp, rng=rng, lora=lora)
    if kind == "llama-no-template":
        model = make_hf_model_dir(tmp, rng=rng)
        cfg = json.loads((model / "config.json").read_text())
        (model / "config.json").write_text(json.dumps(dict(cfg, architectures=["LlamaForCausalLM"])))
        (model / "tokenizer_config.json").unlink()
        return model
    raise ValueError(kind)


def _export(fn, model, out, g, fmt, bits):
    logs = io.StringIO()
    with contextlib.redirect_stdout(logs), contextlib.redirect_stderr(logs):
        return fn(model, out, g, fmt=fmt, weight_bits=bits)


def _artifacts(root: Path, name: str) -> dict[str, bytes]:
    """Every file an export wrote, by its path relative to ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and p.relative_to(root).parts[0].startswith(name)}


CASES = [  # (model, group size requested, format, bits)
    ("base", 16, "native", 8),
    ("base", 16, "legacy", 8),
    ("base", 16, "native", 4),
    ("base", 48, "native", 4),  # the auto-fix halves 48 to 4 for dim 64
    ("base", 48, "legacy", 8),
    ("bf16-shards-own-head", 32, "native", 8),
    ("bf16-shards-own-head", 32, "legacy", 8),
    ("bf16-shards-own-head", 32, "native", 4),
    ("lora", 16, "native", 8),
    ("lora", 16, "legacy", 8),
    ("lora", 16, "native", 4),
    ("llama-no-template", 16, "native", 8),
    ("llama-no-template", 16, "legacy", 8),
]


@pytest.mark.parametrize("kind,g,fmt,bits", CASES, ids=lambda v: str(v))
def test_artifacts_byte_identical_to_the_jax_exporter(tmp_path, kind, g, fmt, bits):
    model = _model(tmp_path, kind)
    ext = ".qtpu" if fmt == "native" else ".bin"
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_report = _export(jax_export, model, tmp_path / "jax" / f"m{ext}", g, fmt, bits)
    port_report = _export(export_model, model, tmp_path / "port" / f"m{ext}", g, fmt, bits)
    want, got = _artifacts(tmp_path / "jax", "m"), _artifacts(tmp_path / "port", "m")
    assert sorted(got) == sorted(want)
    expected = {f"m{ext}", f"m{ext}/config.json", f"m{ext}/tokenizer.bin", f"m{ext}/weights/_layout",
                f"m{ext}/weights/wq.q.npy", f"m{ext}/template"} if fmt == "native" else {
                f"m{ext}", f"m{ext}.tokenizer", f"m{ext}.template"}
    if kind.startswith("llama"):
        expected = {e for e in expected if "template" not in e}
    assert expected - {f"m{ext}"} <= set(got)
    for name in want:
        assert got[name] == want[name], name
    assert port_report == jax_report and len(port_report) > 0
    if fmt == "native":
        config, weights = load_checkpoint(tmp_path / "port" / f"m{ext}")
        assert config.group_size == find_optimal_group_size(64, g) and config.weight_bits == bits
        assert isinstance(weights.layers.w2, Q4Tensor) == (bits == 4)


def test_int4_legacy_is_refused_by_both(tmp_path):
    model = _model(tmp_path, "base")
    errors = []
    for fn, out in ((jax_export, tmp_path / "j.bin"), (export_model, tmp_path / "p.bin")):
        with pytest.raises(ValueError, match="legacy .bin format is Q8_0-only") as e:
            _export(fn, model, out, 16, "legacy", 4)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_cli_export_writes_the_api_bytes(tmp_path):
    model = _model(tmp_path, "base")
    _export(export_model, model, tmp_path / "api.qtpu", 16, "native", 4)
    assert port_main(["export", str(model), str(tmp_path / "cli.qtpu"), "-g", "16", "--bits", "4"]) == 0
    want, got = _artifacts(tmp_path, "api.qtpu"), _artifacts(tmp_path, "cli.qtpu")
    assert [k.replace("api", "cli") for k in want] == list(got)
    assert all(got[k.replace("api", "cli")] == v for k, v in want.items())
    assert port_main(["export", str(model), str(tmp_path / "cli.bin"), "-g", "16", "--format", "legacy"]) == 0
    _export(export_model, model, tmp_path / "api.bin", 16, "legacy", 8)
    for suffix in (".bin", ".bin.tokenizer", ".bin.template"):
        assert (tmp_path / f"cli{suffix}").read_bytes() == (tmp_path / f"api{suffix}").read_bytes()


def test_cli_export_validates_the_model_dir(tmp_path):
    with pytest.raises(SystemExit, match="not a directory"):
        port_main(["export", str(tmp_path / "missing"), str(tmp_path / "o.qtpu")])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="missing: config.json, tokenizer.json"):
        port_main(["export", str(tmp_path / "empty"), str(tmp_path / "o.qtpu")])


def test_export_refuses_what_the_jax_exporter_refuses(tmp_path):
    """A LoRA pair that does not fit its base tensor, and a model whose
    architecture the exporter does not know: the same errors."""
    bad = {"config": {"lora_alpha": 8.0, "r": 2, "target_modules": ["q_proj"]},
           "tensors": {"base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": np.ones((2, 5), np.float32),
                       "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight": np.ones((7, 2), np.float32)}}
    model = make_hf_model_dir(tmp_path / "a", rng=np.random.default_rng(0), lora=bad)
    arch = make_hf_model_dir(tmp_path / "b", rng=np.random.default_rng(0))
    cfg = json.loads((arch / "config.json").read_text())
    (arch / "config.json").write_text(json.dumps(dict(cfg, architectures=["GPT2LMHeadModel"])))
    for m, match in ((model, "Dimension mismatch"), (arch, "Unknown ArchitectureId")):
        errors = []
        for fn, out in ((jax_export, m.parent / "j.qtpu"), (export_model, m.parent / "p.qtpu")):
            with pytest.raises(ValueError, match=match) as e:
                _export(fn, m, out, 16, "native", 8)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
