"""Perplexity evaluation: the port's ``evaluation.py`` against the JAX
package's, in the modes ``fast``, ``f32`` and ``exact``, and the port's
``eval-ppl`` CLI against its API and against the JAX package's CLI.

The JAX side runs its Pallas kernels in interpret mode (the row-blocked,
dequant and W8A8 kernels at these 384-row windows; the xdot gate is lowered
in both packages so that the down-projections take the dequant kernel).
Average NLLs agree to ``1e-3`` relative and perplexities, their
exponentials, to ``5e-3``: the logits differ by summation orders, by the bf16
roundings that XLA on the CPU skips (see ``test_torch_model.py``) and, in
exact mode, by flipped activation codes, which average out over a window's
tokens (measured here: up to 1.2e-4 and 1.1e-3, in exact mode).
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, lower_xdot_gate, route_jax_through_interpret_kernels
from utils import make_hf_model_dir

from qwen3_rs_tpu.cli import main as jax_main
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.evaluation import compute_perplexity as jax_perplexity
from qwen3_rs_tpu.evaluation import logit_kl as jax_logit_kl
from qwen3_rs_tpu_torch.export import export_model
from qwen3_rs_tpu_torch import evaluate_checkpoint
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.evaluation import (
    PerplexityResult,
    compute_perplexity,
    logit_kl,
    quantization_error_bound,
)
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=128, seq_len=384, vocab_size=2176, group_size=64, shared_classifier=True,
)
RTOL_NLL, RTOL_PPL = 1e-3, 5e-3


@pytest.fixture(scope="module")
def model():
    tree = jax_numpy_weights(CONFIG, 11, fast_scales=False)
    tokens = np.random.default_rng(11).integers(0, CONFIG.vocab_size, 600).tolist()
    jcfg = JaxConfig(**dataclasses.asdict(CONFIG))
    return jcfg, jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree), tokens


@pytest.fixture
def kernels(monkeypatch):
    calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    lower_xdot_gate(monkeypatch, min_rows=384, min_elems=0)
    return calls


@pytest.mark.parametrize("mode", ["fast", "f32", "exact"])
def test_perplexity_matches_jax(model, kernels, mode):
    jcfg, jw, pw, tokens = model
    ref = jax_perplexity(jcfg, jw, tokens, mode=mode)
    got = compute_perplexity(CONFIG, pw, tokens, mode=mode)
    assert got.n_tokens == ref.n_tokens == len(tokens) - 1  # two windows, one token of overlap
    assert abs(got.perplexity - ref.perplexity) <= RTOL_PPL * ref.perplexity, (got, ref)
    assert abs(got.avg_nll - ref.avg_nll) <= RTOL_NLL * abs(ref.avg_nll)
    if mode == "fast":
        assert kernels["rows"] and kernels["dequant"]
    if mode == "exact":
        assert kernels["a8"]


def test_short_window_takes_the_fused_kernel_with_cast_scales(model, kernels):
    """A 128-row window reaches the fused W8A16 kernel, which takes bf16 scales."""
    jcfg, jw, pw, tokens = model
    ref = jax_perplexity(jcfg, jw, tokens[:300], mode="fast", window=128)
    got = compute_perplexity(CONFIG, pw, tokens[:300], mode="fast", window=128)
    assert kernels["fused"] and got.n_tokens == ref.n_tokens
    assert abs(got.perplexity - ref.perplexity) <= RTOL_PPL * ref.perplexity


def test_logit_kl_matches_jax(model, kernels):
    jcfg, jw, pw, tokens = model
    """KL(f32 ‖ exact): the activation quantization's ~1e-3 nats stands well
    above the packages' rounding differences (4% of it here), where fast
    mode's ~1e-6 nats would not: a tenth of the reference's value."""
    ref = jax_logit_kl(jcfg, jw, tokens, mode_p="f32", mode_q="exact")
    got = logit_kl(CONFIG, pw, tokens, mode_p="f32", mode_q="exact")
    assert got["n_positions"] == ref["n_positions"] == len(tokens) - 1
    assert 0.0 < got["mean"] <= got["p99"] <= got["max"]
    for key in ("mean", "p99"):
        assert abs(got[key] - ref[key]) <= 0.1 * ref[key], (key, got, ref)


def test_helpers():
    assert quantization_error_bound(CONFIG) == 1.0 / 254
    assert PerplexityResult(3.0, 1.0, 5).delta_vs(PerplexityResult(2.5, 0.9, 5)) == 0.5
    with pytest.raises(ValueError, match="2 tokens"):
        compute_perplexity(CONFIG, None, [1])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evalppl")
    cfg = dataclasses.replace(JaxConfig(**dataclasses.asdict(CONFIG)), seq_len=128, vocab_size=300)
    model_dir = make_hf_model_dir(tmp, config=cfg, rng=np.random.default_rng(5), min_vocab=256)
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model_dir, tmp / "m.qtpu", 64, fmt="native")
    (tmp / "eval.txt").write_text("the quick brown fox jumps over the lazy dog. " * 8)
    return tmp


def _json_stdout(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue())


def test_cli_eval_ppl_matches_api_and_jax_cli(exported, kernels):
    ckpt, text = str(exported / "m.qtpu"), exported / "eval.txt"
    modes = "fast,exact,f32"
    got = _json_stdout(port_main, ["eval-ppl", ckpt, "-f", str(text), "--modes", modes, "--device", "cpu"])
    api = evaluate_checkpoint(ckpt, text=text.read_text(), modes=tuple(modes.split(",")), device="cpu")
    for mode, r in api.items():
        assert got[mode]["perplexity"] == r.perplexity and got[mode]["tokens"] == r.n_tokens
    assert got["fast"]["ppl_delta_vs_f32"] == api["fast"].delta_vs(api["f32"])
    assert "ppl_delta_vs_f32" not in got["f32"]
    want = _json_stdout(jax_main, ["eval-ppl", ckpt, "-f", str(text), "--modes", modes])
    assert set(want) == set(got) and all(set(want[m]) == set(got[m]) for m in want)
    for mode in want:
        assert got[mode]["tokens"] == want[mode]["tokens"] > 100
        assert abs(got[mode]["perplexity"] - want[mode]["perplexity"]) <= RTOL_PPL * want[mode]["perplexity"]
