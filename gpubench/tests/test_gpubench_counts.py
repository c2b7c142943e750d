"""The frozen counts equal the port's ``testing`` arithmetic at the
benchmark's shapes."""

from __future__ import annotations

import json

import pytest

from gpubench import counts, harness
from gpubench.tests.conftest import REPO

testing = pytest.importorskip("qwen3_rs_tpu_torch.testing")


def _both(name):
    shapes = harness.shapes_of(json.loads((REPO / f"gpubench/configs/{name}.json").read_text()))
    cfg = testing.qwen3_config(name.split("-")[1], seq_len=shapes.seq_len, group_size=shapes.group_size)
    return shapes, cfg


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-4b"])
def test_configs_are_the_ports_qwen3_shapes(name):
    shapes, cfg = _both(name)
    for key in ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "head_dim", "vocab_size"):
        assert getattr(shapes, key) == getattr(cfg, key)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-4b"])
@pytest.mark.parametrize("scale_bytes,bits", [(2, 8), (4, 8), (2, 4)])
def test_weight_bytes(name, scale_bytes, bits):
    shapes, cfg = _both(name)
    assert counts.weight_bytes_per_decode_token(shapes, scale_bytes, bits) == \
        testing.weight_bytes_per_decode_token(cfg, scale_bytes, bits)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-4b"])
@pytest.mark.parametrize("rows,cache_rows", [(1, 0), (128, 0), (2048, 0), (952, 2048), (4096, 0)])
def test_prefill_ops(name, rows, cache_rows):
    shapes, cfg = _both(name)
    assert counts.prefill_ops(shapes, rows, cache_rows) == testing.prefill_ops(cfg, rows, cache_rows)


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-4b"])
@pytest.mark.parametrize("pos,v_pad", [([200], None), ([0, 1, 127, 4095, 2049, 300, 5, 17], 153600),
                                       ([4095] * 8, None)])
def test_megakernel_bytes(name, pos, v_pad):
    shapes, cfg = _both(name)
    assert counts.megakernel_bytes(shapes, pos, 2, len(pos), v_pad) == \
        testing.megakernel_bytes(cfg, pos, 2, len(pos), v_pad)


@pytest.mark.parametrize("rows,n,d", [(2048, 4096, 6144), (512, 12288, 4096), (4096, 2560, 19456)])
def test_rows_counts(rows, n, d):
    assert counts.rows_cols_counts(rows, n, d, 64) == testing.rows_cols_counts(rows, n, d, 64)


def test_prefill_attention_ops_are_prefill_ops_attention_per_layer():
    shapes, cfg = _both("qwen3-8b")
    _, ops = counts.prefill_attention_counts(1, 2048, 32, 8, 128)
    assert ops * shapes.n_layers == testing.prefill_ops(cfg, 2048)["attention"]


def test_the_8b_step_bounds_are_the_kernel_tables():
    shapes, _ = _both("qwen3-8b")
    peak = {"hbm_bytes_per_s": 3.35e12, "bf16_ops_per_s": 989e12}
    # kernel table: 7,804,600,320 B of weights a b=1 step, 2.330 ms at 3.35 TB/s
    assert counts.weight_bytes_per_decode_token(shapes, 2) == 7_804_600_320
    # the fresh 2048-row window's projections and attention: 30.02 ms at 989 TFLOP/s
    assert 1e3 * counts.prefill_ops(shapes, 2048)["total"] / peak["bf16_ops_per_s"] == pytest.approx(30.02, abs=0.01)
    assert counts.decode_step_least_s(shapes, [200], peak) > 2.330e-3
