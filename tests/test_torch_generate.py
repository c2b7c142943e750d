"""Generation end to end: the port's CLI ``inference`` against the JAX
package's CLI on an exported fixture, and the host sampler's streams.

A synthetic HF model is exported by the port's exporter (byte-identical to
the JAX exporter's, ``test_torch_export.py``) to ``.qtpu`` and ``.bin``, and
to an INT4 ``.qtpu``; both CLIs run ``generate`` and ``chat`` on it (the port with
``--device cpu``, its kernels' plain versions) and must print the same text,
for greedy and for seeded ``-t 0.8`` streams (xorshift coins, bit-exact on
both sides), and greedy with ``--device-sampling`` (on-device chunks).  The
JAX side runs the path the port follows: its W8A16 and flash-decode kernels in
interpret mode, decode megakernel off (the fixture's widths fail its gate in
both packages).

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

from torch_parity import route_jax_q4_through_interpret_kernels, route_jax_through_interpret_kernels
from utils import TINY_CONFIG, make_hf_model_dir, write_safetensors

from qwen3_rs_tpu.cli import main as jax_main
from qwen3_rs_tpu_torch.export import export_model
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


def _pow2_groups(w, q_max=127.0):
    """Rescale each group of G along the last axis so that its max |w| is
    q_max·2^k: the exporter's scale max|w|/q_max is then a power of two."""
    if w.ndim != 2 or w.shape[-1] % G:
        return w
    gr = w.reshape(-1, G).astype(np.float64)
    amax = np.abs(gr).max(-1)
    target = q_max * 2.0 ** np.round(np.log2(amax / q_max))
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
    # INT4: the same model with its linear layers' groups at 7·2^k.
    for f in model.glob("*.safetensors"):
        tensors = _read_safetensors(f)
        write_safetensors(f, {k: _pow2_groups(v, 7.0) if "layers" in k else v for k, v in tensors.items()})
    with contextlib.redirect_stdout(io.StringIO()):
        export_model(model, tmp / "q4.qtpu", G, fmt="native", weight_bits=4)
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


def test_int4_cli_matches_jax_cli(exported, monkeypatch):
    """An INT4 checkpoint, greedy: the port's Q4 kernels' plain versions
    against the JAX CLI on its interpret-mode Q4 kernels (its fused glue off:
    its fused kernel misreads packed codes, ``test_torch_q4.py``), the same
    text; exact mode raises in both."""
    calls = route_jax_q4_through_interpret_kernels(monkeypatch, min_seq_len=CONFIG.seq_len)
    ckpt, run = str(exported / "q4.qtpu"), RUNS["generate-greedy"]
    want = _stdout(jax_main, ["inference", ckpt, "--engine-mode", "fast", *run])
    assert calls["stacked"] and calls["head"] and calls["flash"] and not calls["fused"]
    got = _stdout(port_main, ["inference", ckpt, "--device", "cpu", *run])
    assert len(want) > 40
    assert got == want
    for main, extra in ((jax_main, []), (port_main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="INT4 weights have no reference-exact"):
            _stdout(main, ["inference", ckpt, "--engine-mode", "exact", *extra, *run])


@pytest.mark.parametrize("run", ["generate-greedy", "generate-t0.8", "chat-greedy"])
def test_cli_exact_mode_matches_jax_cli(exported, run, monkeypatch):
    """``--engine-mode exact`` (W8A8): prompt windows under 128 rows and
    decode steps take the reference's group scan on both sides.  The scan's
    last multiply and add are one FMA under XLA on the CPU and two roundings
    in the port, which can flip an activation code; a 64-row context keeps
    the streams short enough that such a flip does not change a sampled
    token here."""
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=CONFIG.seq_len)
    ckpt = str(exported / "m.qtpu")
    flags = ["--engine-mode", "exact", "-c", "64", *RUNS[run]]
    want = _stdout(jax_main, ["inference", ckpt, *flags])
    got = _stdout(port_main, ["inference", ckpt, "--device", "cpu", *flags])
    assert len(want) > 30
    assert got == want


@pytest.mark.parametrize("run", ["generate-greedy", "chat-greedy"])
def test_cli_device_sampling_greedy_matches_host_and_jax_cli(exported, run, monkeypatch):
    """``--device-sampling -t 0``: decode in on-device chunks (greedy picks
    the last maximum, as the host sampler does) prints the text of the host
    loop, and of the JAX CLI's device sampling (its ``decode_chunk`` scan)."""
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=CONFIG.seq_len)
    ckpt = str(exported / "m.qtpu")
    host = _stdout(port_main, ["inference", ckpt, "--device", "cpu", *RUNS[run]])
    got = _stdout(port_main, ["inference", ckpt, "--device", "cpu", "--device-sampling", *RUNS[run]])
    assert len(host) > 40 and got == host
    if run.startswith("generate"):
        assert got == _stdout(jax_main, ["inference", ckpt, "--engine-mode", "fast", "--device-sampling", *RUNS[run]])


def test_cli_device_sampling_repeats_per_seed(exported):
    argv = ["inference", str(exported / "m.qtpu"), "--device", "cpu", "--device-sampling", *RUNS["generate-t0.8"]]
    assert _stdout(port_main, argv) == _stdout(port_main, argv)


@pytest.mark.parametrize("flags,what", [
    (["-m", "generate", "--device-sampling", "--spec", "2", "-t", "0.8"], "requires temperature 0"),
    (["-m", "chat", "--spec", "2", "-t", "0"], "generate-mode only"),
])
def test_spec_flags_raise_the_jax_errors(exported, flags, what):
    """``--spec`` outside its greedy generate loop: the JAX CLI's error,
    word for word."""
    argv = ["inference", str(exported / "m.qtpu"), "-i", "hi", *flags]
    with pytest.raises(ValueError, match=what) as want:
        jax_main(argv)
    with pytest.raises(ValueError, match=what) as got:
        port_main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value)


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
