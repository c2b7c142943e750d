"""Generation end to end: the port's CLI ``inference`` against the JAX
package's CLI on an exported fixture, and the host sampler's streams.

A synthetic HF model is exported by the JAX exporter to ``.qtpu`` and
``.bin``; both CLIs run ``generate`` and ``chat`` on it (the port with
``--device cpu``, its kernels' plain versions) and must print the same text,
for greedy and for seeded ``-t 0.8`` streams (xorshift coins, bit-exact on
both sides).  The JAX side runs the path the port follows: its W8A16 and
flash-decode kernels in interpret mode, decode megakernel off.

A sampled stream follows the logits' ranking, so the fixture keeps the two
sides' logits within f32 summation order of each other: widths of 128
multiples (the JAX kernels' tiling), power-of-two quantization scales (exact
``code · scale`` in bf16, which XLA on the CPU would not round), and a final
norm weight scaled by 20 so that the next-token distributions are peaked
rather than near-uniform over the vocabulary.  Even so, a summation-order
ulp can flip one bf16 rounding of the residual stream; the logits then move
by ~0.5% (``test_torch_model.py``), which these peaked streams absorb.  An
INT8 cache turns such an ulp into a whole code step now and then, so its
streams are held to the JAX forward at a tolerance there, not here.
"""

import contextlib
import dataclasses
import io
import json
import struct

import numpy as np
import pytest
import torch

from torch_parity import route_jax_through_interpret_kernels
from utils import TINY_CONFIG, make_hf_model_dir, write_safetensors

from qwen3_rs_tpu.cli import main as jax_main
from qwen3_rs_tpu.export import export_model
from qwen3_rs_tpu.inference.engine import TokenSampler as JaxTokenSampler
from qwen3_rs_tpu.ops.sampling import Sampler as JaxSampler
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.inference.engine import TokenSampler
from qwen3_rs_tpu_torch.ops.sampling import Sampler

torch.set_num_threads(2)

G = 64
CONFIG = dataclasses.replace(
    TINY_CONFIG, dim=256, hidden_dim=512, n_heads=2, n_kv_heads=1, head_dim=128,
    seq_len=128, group_size=G,
)


def _read_safetensors(path):
    raw = path.read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8 : 8 + n])
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        assert meta["dtype"] == "F32"
        lo, hi = meta["data_offsets"]
        out[name] = np.frombuffer(raw[8 + n + lo : 8 + n + hi], "<f4").reshape(meta["shape"]).copy()
    return out


def _pow2_groups(w):
    """Rescale each group of G along the last axis so that its max |w| is
    127·2^k: the exporter's scale max|w|/127 is then a power of two."""
    if w.ndim != 2 or w.shape[-1] % G:
        return w
    gr = w.reshape(-1, G).astype(np.float64)
    amax = np.abs(gr).max(-1)
    target = 127.0 * 2.0 ** np.round(np.log2(amax / 127.0))
    gr *= (target / amax)[:, None]
    top = np.abs(gr).argmax(-1)
    rows = np.arange(len(gr))
    gr[rows, top] = np.sign(gr[rows, top]) * target
    return gr.reshape(w.shape).astype(np.float32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gen")
    model = make_hf_model_dir(tmp, config=CONFIG, rng=np.random.default_rng(8), min_vocab=256)
    for f in model.glob("*.safetensors"):
        tensors = _read_safetensors(f)
        if "model.norm.weight" in tensors:
            tensors["model.norm.weight"] = tensors["model.norm.weight"] * 20.0
        write_safetensors(f, {k: _pow2_groups(v) for k, v in tensors.items()})
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model, tmp / "m.qtpu", G, fmt="native")
        export_model(model, tmp / "m.bin", G, fmt="legacy")
    return tmp


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


RUNS = {
    "generate-greedy": ["-m", "generate", "-i", "hello world", "-t", "0", "-s", "1"],
    "generate-t0.8": ["-m", "generate", "-i", "hello world", "-t", "0.8", "-s", "7"],
    "chat-greedy": ["-m", "chat", "-i", "hi there", "-y", "be kind", "-t", "0", "-s", "2"],
    "chat-t0.8": ["-m", "chat", "-i", "hi there", "-t", "0.8", "-s", "3"],
}


@pytest.mark.parametrize("fmt", ["m.qtpu", "m.bin"])
@pytest.mark.parametrize("run", list(RUNS))
def test_cli_matches_jax_cli(exported, fmt, run, monkeypatch):
    calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=CONFIG.seq_len)
    ckpt = str(exported / fmt)
    want = _stdout(jax_main, ["inference", ckpt, "--engine-mode", "fast", *RUNS[run]])
    assert calls["fused"] and calls["head"] and calls["flash"]
    got = _stdout(port_main, ["inference", ckpt, "--device", "cpu", *RUNS[run]])
    assert len(want) > 40
    assert got == want


@pytest.mark.parametrize("flag", [["--engine-mode", "exact"], ["--device-sampling"],
                                  ["--spec", "2"], ["--sp", "2"]])
def test_unported_flags_raise(exported, flag):
    argv = ["inference", str(exported / "m.qtpu"), "--device", "cpu", "-m", "generate",
            "-i", "hi", *flag]
    with pytest.raises(NotImplementedError, match="not ported.*ROADMAP.md"):
        port_main(argv)


@pytest.mark.parametrize("temperature,topp", [(0.0, 0.9), (0.8, 0.9), (1.0, 1.0), (0.5, 0.0)])
def test_sampler_stream_matches_jax(temperature, topp):
    rng = np.random.default_rng(int(temperature * 10 + topp * 100))
    ours, ref = Sampler(temperature, topp, 42), JaxSampler(temperature, topp, 42)
    for _ in range(64):
        logits = rng.normal(0, 3, 300).astype(np.float32)
        assert ours.sample(logits) == ref.sample(logits)
    assert int(ours.rng.state) == int(ref.rng.state)


def test_skip_draws_matches_jax():
    rng = np.random.default_rng(3)
    ours, ref = TokenSampler(0.8, 0.9, 11), JaxTokenSampler(0.8, 0.9, 11)
    for n in (0, 1, 5):
        ours.skip_draws(n)
        ref.skip_draws(n)
        logits = rng.normal(0, 2, 50).astype(np.float32)
        assert ours.sample(torch.from_numpy(logits)) == ref.sample(logits)
