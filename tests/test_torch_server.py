"""The serving front end and the ``batch`` / ``serve`` CLI: every HTTP
endpoint of the port's server on the CPU, ``render_chat`` against the JAX
package's, ``batch`` JSON lines against the JAX CLI's (``--sampling host`` and the
default device sampling), ``serve`` with its defaults and the card default
(``serve --replicas`` and ``--gateway``: ``test_torch_replicated.py``,
``test_torch_remote.py``)."""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_generate import CONFIG as GEN_CONFIG
from test_torch_generate import exported  # noqa: F401  (the exported fixture checkpoint)
from torch_parity import jax_numpy_weights, route_jax_through_interpret_kernels

from qwen3_rs_tpu.cli import main as jax_main
from qwen3_rs_tpu.serving.server import render_chat as jax_render_chat
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request, ServingFrontend, render_chat, serve

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=1, n_heads=4, n_kv_heads=2,
    head_dim=128, seq_len=64, vocab_size=256, group_size=64, shared_classifier=True,
)


class FakeTokenizer:
    """Token-id passthrough, enough for the plumbing."""

    bos_token_id = 1
    eos_token_id = 2
    prompt_template = "<u>%s</u><a>"
    system_prompt_template = "<sys>%s</sys><a>"

    def encode(self, text):
        return [3 + (ord(c) % 90) for c in text][:8] or [3]

    def decode(self, tokens):
        return " ".join(str(t) for t in tokens)

    def decode_bytes(self, token):
        return f"{token} ".encode()


def _engine(**kw):
    weights = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 5, fast_scales=False))
    return ContinuousBatchingEngine(config=CONFIG, weights=weights, n_slots=2, prefill_buckets=(8, 16),
                                    kv_layout="paged", page_size=16, device="cpu", **kw)


@pytest.fixture(scope="module")
def server():
    engine = _engine()
    engine.warmup()
    fe = ServingFrontend(engine, FakeTokenizer())
    bound = threading.Event()
    box = {}

    def ready(httpd):
        box["httpd"] = httpd
        bound.set()

    t = threading.Thread(target=serve, args=(fe, "127.0.0.1", 0), kwargs={"ready": ready}, daemon=True)
    t.start()
    assert bound.wait(30)
    yield fe, box["httpd"].server_address[1]
    box["httpd"].shutdown()
    t.join(30)


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _solo(prompt_tokens, max_new):
    """The same request alone through a fresh engine's run()."""
    engine = _engine()
    engine.submit(Request(0, prompt_tokens, max_new_tokens=max_new, eos_token_ids=(1, 2)))
    return engine.run()[0].generated


def test_health_and_stats(server):
    _, port = server
    assert json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/health").read()) == {"status": "ok"}
    stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats").read())
    assert {"completed", "decode_steps", "slot_utilization", "kv_pages_total", "kv_pages_free"} <= set(stats)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope")
    assert e.value.code == 404


def test_completion_equals_a_solo_run(server):
    _, port = server
    body = json.loads(_post(port, "/v1/completions", {"prompt": "hello", "max_tokens": 5}).read())
    want = _solo(FakeTokenizer().encode("hello"), 5)
    assert body["text"] == FakeTokenizer().decode(want) and body["tokens"] == len(want)
    assert body["finish_reason"] in ("length", "stop") and body["ttft_s"] > 0


def test_streaming(server):
    _, port = server
    raw = _post(port, "/v1/completions", {"prompt": "abc", "max_tokens": 4, "stream": True}).read()
    lines = [json.loads(x) for x in raw.decode().splitlines() if x.strip()]
    tokens = [x["token"] for x in lines if "token" in x]
    assert tokens == _solo(FakeTokenizer().encode("abc"), 4)
    assert lines[-1]["done"] and lines[-1]["tokens"] == len(tokens)


def test_chat_completion(server):
    _, port = server
    messages = [{"role": "system", "content": "s"}, {"role": "user", "content": "hi"}]
    body = json.loads(_post(port, "/v1/chat/completions", {"messages": messages, "max_tokens": 3}).read())
    want = _solo(FakeTokenizer().encode(render_chat(messages, FakeTokenizer())), 3)
    assert body["message"] == {"role": "assistant", "content": FakeTokenizer().decode(want)}


def test_concurrent_completions(server):
    _, port = server
    results = [None] * 5

    def one(i):
        results[i] = json.loads(_post(port, "/v1/completions", {"prompt": f"p{i}", "max_tokens": 4}).read())

    threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert all(r is not None and r["finish_reason"] in ("length", "stop") for r in results)


def test_bad_request(server):
    _, port = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/chat/completions", {"messages": [{"role": "bot", "content": "x"}]})
    assert e.value.code == 400


def test_engine_failure_fails_the_request():
    """A step that raises fails its requests with the error (HTTP 500 through
    the handler), and later submissions too; nothing hangs."""
    engine = _engine()

    def broken():
        raise RuntimeError("launch failed")

    engine.step = broken
    fe = ServingFrontend(engine, FakeTokenizer())
    p = fe.submit("x", max_tokens=2, stream=True)
    assert p.done.wait(30) and p.error == "RuntimeError: launch failed"
    assert p.tokens.get(timeout=5) is None
    later = fe.submit("y", max_tokens=2)
    assert later.done.wait(30) and later.error == fe.error
    fe.shutdown()


@pytest.mark.parametrize("messages", [
    [{"role": "user", "content": "a"}],
    [{"role": "system", "content": "s"}, {"role": "user", "content": "a"},
     {"role": "assistant", "content": "b"}, {"role": "user", "content": "c"}],
])
def test_render_chat_matches_jax(messages):
    tok = FakeTokenizer()
    assert render_chat(messages, tok) == jax_render_chat(messages, tok)
    with pytest.raises(ValueError):
        render_chat([{"role": "system", "content": "s"}], tok)


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("flags", [["--kv", "dense"], ["--kv", "paged", "--page-size", "128", "--prefix-cache"]])
def test_batch_cli_matches_jax_cli(exported, tmp_path, flags, monkeypatch):  # noqa: F811
    """``batch --sampling host`` on the exported fixture: the same JSON lines
    as the JAX CLI (its forward through its interpret-mode kernels, the path
    the port follows)."""
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=GEN_CONFIG.seq_len)
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello world\n\nthe cat\nhello world again\n")
    argv = ["batch", str(exported / "m.qtpu"), "-f", str(prompts), "-n", "6", "--sampling", "host",
            "--no-warmup", "--slots", "2", *flags]
    want = _stdout(jax_main, argv)
    got = _stdout(port_main, [*argv, "--device", "cpu"])
    lines = [json.loads(x) for x in got.splitlines()]
    assert [x["id"] for x in lines] == [0, 1, 2] and all(x["tokens"] > 0 for x in lines)
    assert set(lines[0]) == {"id", "prompt", "completion", "tokens", "finish_reason"}
    assert got == want


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_batch_cli_defaults_match_jax_cli(exported, tmp_path, kv, monkeypatch):  # noqa: F811
    """``batch`` with no ``--sampling`` flag (device sampling, greedy by
    default): the same JSON lines as the JAX CLI's default run, its forward
    through its interpret-mode kernels."""
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=GEN_CONFIG.seq_len)
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello world\nthe cat\nhello world again\n")
    argv = ["batch", str(exported / "m.qtpu"), "-f", str(prompts), "-n", "6", "--no-warmup", "--slots", "2",
            "--kv", kv]
    want = _stdout(jax_main, argv)
    got = _stdout(port_main, [*argv, "--device", "cpu"])
    lines = [json.loads(x) for x in got.splitlines()]
    assert [x["id"] for x in lines] == [0, 1, 2] and all(x["tokens"] > 0 for x in lines)
    assert got == want


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_serve_cli_defaults_answer_as_the_api(exported, kv, monkeypatch):  # noqa: F811
    """``serve`` with no ``--sampling`` flag (device sampling; the paged pool
    by default): a greedy completion over HTTP equals the same request run
    through the API's engine."""
    import qwen3_rs_tpu_torch.serving.server as server_mod
    from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
    from qwen3_rs_tpu_torch.inference.tokenizer import Tokenizer

    real_serve, box = server_mod.serve, {}

    def serve_once(frontend, host, port):
        box["sampling"] = frontend.engine.sampling, frontend.engine.kv_layout

        def ready(httpd):
            def ask():
                try:
                    box["body"] = json.loads(_post(httpd.server_address[1], "/v1/completions",
                                                   {"prompt": "hello world", "max_tokens": 5}).read())
                finally:
                    httpd.shutdown()

            threading.Thread(target=ask, daemon=True).start()

        real_serve(frontend, host, 0, ready=ready)

    monkeypatch.setattr(server_mod, "serve", serve_once)
    flags = [] if kv == "paged" else ["--kv", "dense"]
    assert port_main(["serve", str(exported / "m.qtpu"), "--no-warmup", "--slots", "2", *flags,
                      "--device", "cpu"]) == 0
    assert box["sampling"] == ("device", kv)
    config, weights = load_checkpoint(exported / "m.qtpu")
    tok = Tokenizer(exported / "m.qtpu", config.vocab_size)
    engine = ContinuousBatchingEngine(config=config, weights=weights, n_slots=2, kv_layout=kv, sampling="device",
                                      device="cpu")
    engine.submit(Request(0, tok.encode("hello world"), max_new_tokens=5,
                          eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
    want = engine.run()[0].generated
    assert box["body"]["text"] == tok.decode(want) and box["body"]["tokens"] == len(want)


@pytest.mark.parametrize("argv,error", [
    (["batch", "-f", "p.txt", "--sampling", "host", "--spec", "2"], SystemExit),
    (["batch", "-f", "p.txt", "--sampling", "host", "--kv", "paged", "--spec", "2"], ValueError),
])
def test_spec_serving_flags_raise_the_jax_errors(exported, argv, error):  # noqa: F811
    """``batch --spec`` off the page pool or with host sampling: the JAX
    CLI's error for the same call, word for word."""
    argv = [argv[0], str(exported / "m.qtpu"), *argv[1:]]
    with pytest.raises(error) as want:
        jax_main(argv)
    with pytest.raises(error) as got:
        port_main([*argv, "--device", "cpu"])
    assert str(got.value) == str(want.value) and "paged" in str(want.value)


def test_batch_defaults_to_the_card(exported, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prompts = tmp_path / "p.txt"
    prompts.write_text("hi\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["batch", str(exported / "m.qtpu"), "-f", str(prompts), "--sampling", "host"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["serve", str(exported / "m.qtpu"), "--sampling", "host"])
