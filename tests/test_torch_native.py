"""The port's host helper (``qwen3_rs_tpu_torch/utils/native.py``, built with
the host C++ compiler from the port's own ``csrc/*.cpp``) against the JAX
package's: the BPE encoder's ids and the loader's transpose, the tokenizer
and the checkpoint loader taking it, its build and failure semantics, and
``enable_compile_cache``."""

import json
import stat

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from utils import make_hf_model_dir

import qwen3_rs_tpu.utils.native as jax_native
import qwen3_rs_tpu_torch.checkpoint as port_checkpoint
from qwen3_rs_tpu.inference.tokenizer import Tokenizer as JaxTokenizer
from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
from qwen3_rs_tpu_torch.export import export_model
from qwen3_rs_tpu_torch.inference.tokenizer import Tokenizer
from qwen3_rs_tpu_torch.ops.kernels import build
from qwen3_rs_tpu_torch.utils import enable_compile_cache, native
from qwen3_rs_tpu_torch.utils.native import NativeBpeEncoder, load_library, native_transpose

# tests/test_native_tokenizer.py's cases.
CASES = [
    "hello world!",
    "hello",
    "<|im_start|>user\nhello<|im_end|>",
    "<zz> not special",
    "a b c",
    "",
    "he said: hello hello hello",
    "<<>>",
    "x" * 200,
    "é unknown chars é",
]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A tiny HF model exported by the port, native and legacy."""
    tmp = tmp_path_factory.mktemp("native")
    hf = make_hf_model_dir(tmp, rng=np.random.default_rng(5))
    vocab_size = json.loads((hf / "config.json").read_text())["vocab_size"]
    export_model(hf, tmp / "m.qtpu", 16, fmt="native")
    export_model(hf, tmp / "m.bin", 16, fmt="legacy")
    return tmp, vocab_size


@pytest.fixture(scope="module")
def toks(model):
    tmp, vocab_size = model
    assert load_library() is not None, "the host helper builds here (g++)"
    port = Tokenizer(tmp / "m.qtpu", vocab_size)
    ref = JaxTokenizer(tmp / "m.qtpu", vocab_size)
    assert jax_native.load_library() is not None
    encoders = (NativeBpeEncoder(port.vocab, port.merge_scores, port.max_token_length),
                jax_native.NativeBpeEncoder(ref.vocab, ref.merge_scores, ref.max_token_length))
    return port, ref, encoders


def _all_equal(toks, text):
    port, ref, (mine, theirs) = toks
    want = ref._encode_py(text)
    assert mine.encode(text) == theirs.encode(text) == want, repr(text)
    assert port.encode(text) == port._encode_py(text) == want, repr(text)


@pytest.mark.parametrize("text", CASES)
def test_encoder_matches_jax(toks, text):
    _all_equal(toks, text)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(list("abcdefgh <|>imstarenduk_!\né€😀")), max_size=60))
def test_encoder_fuzz_matches_jax(toks, text):
    _all_equal(toks, text)


def test_tokenizer_takes_the_native_encoder(toks):
    port = toks[0]
    before = native.CALLS["encode"]
    assert isinstance(port._native_encoder(), NativeBpeEncoder)
    port.encode("hello world")
    assert native.CALLS["encode"] == before + 1


@pytest.mark.parametrize("shape,dtype", [((3, 100, 257), np.int8), ((5, 64, 64), np.float32), ((1000, 4096), np.int8),
                                         ((2, 1, 129, 7), np.int8), ((1, 1), np.float32), ((7, 300), np.float32)])
def test_transpose_matches_jax_and_numpy(shape, dtype):
    rng = np.random.default_rng(1)
    src = (rng.integers(-128, 128, shape) if dtype == np.int8 else rng.normal(size=shape)).astype(dtype)
    got = native_transpose(src)
    assert got.dtype == dtype and got.flags.c_contiguous
    np.testing.assert_array_equal(got, np.swapaxes(src, -1, -2))
    np.testing.assert_array_equal(got, jax_native.native_transpose(src))
    # A strided view is made contiguous first, as JAX does.
    view = src[..., ::2] if src.shape[-1] > 1 else src
    np.testing.assert_array_equal(native_transpose(view), np.swapaxes(view, -1, -2))


@pytest.mark.parametrize("src", [np.zeros(8, np.int8), np.zeros((4, 4), np.int16), np.zeros((2, 3), np.float64)],
                         ids=["1-D", "int16", "f64"])
def test_transpose_refuses_what_jax_refuses(src):
    assert native_transpose(src) is None and jax_native.native_transpose(src) is None


@pytest.mark.parametrize("name", ["m.qtpu", "m.bin"])
def test_checkpoint_loads_bit_identical_with_and_without_the_helper(model, monkeypatch, name):
    """The legacy layout stores every linear layer row-major (each through
    the helper's transpose), the native one the classifier."""
    path = model[0] / name
    before = native.CALLS["transpose"]
    cfg, w = load_checkpoint(path)
    assert native.CALLS["transpose"] > before
    monkeypatch.setattr(port_checkpoint, "native_transpose", lambda a: None)
    cfg_np, w_np = load_checkpoint(path)
    assert cfg == cfg_np

    def leaves(tree):
        return [t for x in tree for t in (leaves(x) if isinstance(x, tuple) else [x])]

    a, b = leaves(w), leaves(w_np)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and x.is_contiguous()
        assert torch.equal(x.view(torch.uint8) if x.dtype != torch.uint8 else x,
                           y.view(torch.uint8) if y.dtype != torch.uint8 else y)


@pytest.fixture
def fresh_helper(monkeypatch, tmp_path):
    """The helper unloaded, its build directory empty (``tmp_path/cache``)."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "cache")
    return tmp_path


def test_no_compiler_takes_the_python_paths(fresh_helper, monkeypatch, model):
    monkeypatch.setattr(native, "compiler", lambda: None)
    assert load_library() is None and native.native_transpose(np.eye(2, dtype=np.int8)) is None
    with pytest.raises(ImportError):
        NativeBpeEncoder([b"a"], [0.0], 1)
    tok = Tokenizer(model[0] / "m.qtpu", model[1])
    assert tok.encode("hello world") == tok._encode_py("hello world") and tok._cpp is False


def test_failed_build_raises_with_the_compilers_output(fresh_helper, monkeypatch):
    cxx = fresh_helper / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: no such thing' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "compiler", lambda: str(cxx))
    with pytest.raises(RuntimeError, match="cxx: no such thing"):
        load_library()
    assert not any((fresh_helper / "cache").glob("*.tmp"))


def test_build_installs_into_the_cache_directory(fresh_helper):
    """The library builds into the build directory under a name hashed over
    the sources and flags (not the JAX helper's), by an atomic rename."""
    assert enable_compile_cache(str(fresh_helper / "cache")) == str(fresh_helper / "cache")
    lib = load_library()
    assert lib is not None and native.lib_path().parent == fresh_helper / "cache"
    assert native.lib_path().name.startswith("libhost_helper-") and "libqwen3_host" not in str(native.lib_path())
    assert sorted(p.name for p in (fresh_helper / "cache").iterdir()) == [native.lib_path().name]
    assert (native.native_transpose(np.arange(6, dtype=np.float32).reshape(2, 3)) == [[0, 3], [1, 4], [2, 5]]).all()


def test_enable_compile_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    assert enable_compile_cache(str(tmp_path / "a" / "b")) == str(tmp_path / "a" / "b")
    assert build.BUILD_DIR == tmp_path / "a" / "b" and build.lib_path("dequant").parent == tmp_path / "a" / "b"
    (tmp_path / "file").write_text("")
    assert enable_compile_cache(str(tmp_path / "file" / "sub")) is None  # cannot be created: left as it was
    assert build.BUILD_DIR == tmp_path / "a" / "b"
    default = build.DEFAULT_BUILD_DIR
    assert enable_compile_cache() == str(default) and build.BUILD_DIR == default
    assert default.name == "build" and default.parent.name == "qwen3_rs_tpu_torch"


def test_cli_enables_the_cache_for_every_command_but_export(monkeypatch, tmp_path):
    import qwen3_rs_tpu_torch
    import qwen3_rs_tpu_torch.utils as port_utils
    from qwen3_rs_tpu_torch.cli import main

    calls = []
    monkeypatch.setattr(port_utils, "enable_compile_cache", lambda *a: calls.append(a))
    monkeypatch.setattr(qwen3_rs_tpu_torch, "run_inference", lambda cfg: None)
    assert main(["inference", "m.qtpu", "--device", "cpu"]) == 0
    assert calls == [()]
    with pytest.raises(SystemExit):
        main(["export", str(tmp_path / "missing"), str(tmp_path / "out.qtpu")])
    assert calls == [()]
