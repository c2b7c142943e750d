"""Checkpoint reader and configuration: the port against the JAX package.

The synthetic HF fixture is exported by the JAX exporter to a native
``.qtpu`` directory (in-major v2, and a row-major v1 copy), to a legacy
``.bin`` and to an INT4 ``.qtpu``; every tensor the port loads must equal
what ``qwen3_rs_tpu.checkpoint.load_checkpoint`` returns, bit for bit, and so
must the config, its ``config.json`` and its 256-byte header.
"""

import contextlib
import dataclasses
import io
import json
import shutil

import numpy as np
import pytest
import torch

from utils import make_hf_model_dir

from qwen3_rs_tpu.checkpoint import load_checkpoint as jax_load
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.export import export_model
from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
from qwen3_rs_tpu_torch.configuration import ModelConfig, read_config

torch.set_num_threads(2)

IN_MAJOR = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _to_v1(src, dst):
    """Rewrite a v2 (in-major) native checkpoint in the v1 row-major layout."""
    shutil.copytree(src, dst)
    w = dst / "weights"
    (w / "_layout").unlink()
    for name in IN_MAJOR:
        for part in ("q", "s"):
            f = w / f"{name}.{part}.npy"
            np.save(f, np.ascontiguousarray(np.swapaxes(np.load(f), -1, -2)))


@pytest.fixture(scope="module", params=[True, False], ids=["shared", "own_head"])
def exported(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    # A vocab past VOCAB_PAD_MULTIPLE exercises the classifier padding.
    model = make_hf_model_dir(
        tmp, rng=np.random.default_rng(5), shared_classifier=request.param, min_vocab=2100
    )
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model, tmp / "m.qtpu", 16, fmt="native")
        export_model(model, tmp / "m.bin", 16, fmt="legacy")
    _to_v1(tmp / "m.qtpu", tmp / "m_v1.qtpu")
    return tmp


def _assert_same(jax_tree, port):
    assert type(port).__name__ == type(jax_tree).__name__
    for name in jax_tree._fields:
        j, p = getattr(jax_tree, name), getattr(port, name)
        if hasattr(j, "_fields"):
            _assert_same(j, p)
            continue
        j = np.asarray(j)
        assert isinstance(p, torch.Tensor), name
        assert p.device.type == "cpu" and p.is_contiguous(), name
        assert p.numpy().dtype == j.dtype and p.shape == j.shape, (name, p.shape, j.shape)
        np.testing.assert_array_equal(p.numpy(), j, err_msg=name)


@pytest.mark.parametrize("name", ["m.qtpu", "m_v1.qtpu", "m.bin"])
def test_tensors_equal_the_jax_loader(exported, name):
    jc, jw = jax_load(exported / name)
    pc, pw = load_checkpoint(exported / name)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pw.lm_head.q.shape[1] == 4096  # 2105 padded to a multiple of 2048
    _assert_same(jw, pw)


def test_config_header_and_json_bit_exact(exported):
    jc, _ = jax_load(exported / "m.qtpu")
    pc = read_config(exported / "m.qtpu")
    assert pc.to_native_json() == jc.to_native_json()
    assert pc.to_legacy_header() == jc.to_legacy_header()
    assert read_config(exported / "m.bin") == ModelConfig.from_legacy_header(jc.to_legacy_header())
    for cfg in (pc, dataclasses.replace(pc, architecture_id=2, use_qk_norm=False, rope_theta=5e5)):
        jcfg = JaxConfig(**dataclasses.asdict(cfg))
        assert cfg.to_legacy_header() == jcfg.to_legacy_header()
        assert ModelConfig.from_legacy_header(jcfg.to_legacy_header()) == cfg
        assert ModelConfig.from_native_json(jcfg.to_native_json()) == cfg
        assert cfg.with_seq_len(8) == ModelConfig(**dataclasses.asdict(jcfg.with_seq_len(8)))


def test_int4_checkpoint_is_refused(tmp_path):
    """An INT4 checkpoint loads: its linear layers as ``Q4Tensor`` (packed
    uint8 codes, f32 scales) bit for bit equal to the JAX loader's, the
    embedding and the classifier INT8."""
    model = make_hf_model_dir(tmp_path, rng=np.random.default_rng(2))
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model, tmp_path / "q4.qtpu", 16, fmt="native", weight_bits=4)
    jc, jw = jax_load(tmp_path / "q4.qtpu")
    pc, pw = load_checkpoint(tmp_path / "q4.qtpu")
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc) and pc.weight_bits == 4
    assert type(pw.layers.wqkv).__name__ == "Q4Tensor" and pw.layers.wqkv.q.dtype == torch.uint8
    assert pw.layers.wqkv.shape == (pc.n_layers, pc.dim, pc.all_heads_dim + 2 * pc.kv_dim)
    assert type(pw.lm_head).__name__ == type(pw.embed).__name__ == "QuantizedTensor"
    _assert_same(jw, pw)


def test_int4_legacy_bin_and_old_int4_exports_are_refused(tmp_path):
    """The legacy ``.bin`` is INT8 only (its header has no code width): the
    writer refuses INT4 with the JAX error.  A native INT4 export without the
    biased-v2 marker, or in the row-major v1 layout, is refused at load with
    the JAX errors."""
    model = make_hf_model_dir(tmp_path, rng=np.random.default_rng(2))
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model, tmp_path / "q4.qtpu", 16, fmt="native", weight_bits=4)
    pc = read_config(tmp_path / "q4.qtpu")
    jc = JaxConfig(**dataclasses.asdict(pc))
    with pytest.raises(ValueError, match="legacy .bin format is Q8_0-only") as port_err:
        pc.to_legacy_header()
    with pytest.raises(ValueError) as jax_err:
        jc.to_legacy_header()
    assert str(port_err.value) == str(jax_err.value)
    cfg = json.loads((tmp_path / "q4.qtpu" / "config.json").read_text())
    old = tmp_path / "old.qtpu"
    shutil.copytree(tmp_path / "q4.qtpu", old)
    (old / "config.json").write_text(json.dumps({k: v for k, v in cfg.items() if k != "q4_pack"}))
    errors = []
    for load in (load_checkpoint, jax_load):
        with pytest.raises(ValueError, match="pre-biased-v2 nibble packing") as e:
            load(old)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    (tmp_path / "q4.qtpu" / "weights" / "_layout").unlink()
    for load in (load_checkpoint, jax_load):
        with pytest.raises(ValueError, match="INT4 checkpoints require the in-major"):
            load(tmp_path / "q4.qtpu")
