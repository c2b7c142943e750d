"""Cross-host serving: the port's gateway (``serving/remote.py``) over worker
servers of the port, the cases of the JAX package's ``test_remote.py``.

* Two worker servers (each its own engine and page pool, in this process,
  over real sockets) behind ``connect_workers``: the streams equal one
  engine's, both workers took requests; a client's stream; the whole HTTP
  stack (client → gateway server → worker → engine) and its summed stats; a
  worker that never answers raises ``TimeoutError``.
* A worker's failure becomes the request's ``finish_reason``: a refused
  connection, and a worker whose engine fails (its stream ends with the
  error).
* ``cli.py serve CKPT --gateway URL,URL`` in a process of its own over two
  workers of the exported checkpoint: streamed and whole completions equal
  the API's.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import pytest
import torch

from test_torch_generate import exported  # noqa: F401  (the exported fixture checkpoint)
from test_torch_server import CONFIG, FakeTokenizer
from torch_parity import jax_numpy_weights

from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
from qwen3_rs_tpu_torch.inference.tokenizer import Tokenizer
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy
from qwen3_rs_tpu_torch.parallel.distributed import free_port
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request, ServingFrontend
from qwen3_rs_tpu_torch.serving.remote import RemoteWorkerClient, connect_workers
from qwen3_rs_tpu_torch.serving.server import make_handler

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _engine(config, weights):
    return ContinuousBatchingEngine(config=config, weights=weights, n_slots=2, prefill_buckets=(8, 16),
                                    kv_layout="paged", page_size=16, device="cpu")


def _worker(engine, tokenizer):
    fe = ServingFrontend(engine, tokenizer)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(fe))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return fe, httpd


def _weights():
    return weights_from_jax_numpy(jax_numpy_weights(CONFIG, 5, fast_scales=False))


@pytest.fixture(scope="module")
def workers():
    weights = _weights()
    made = [_worker(_engine(CONFIG, weights), FakeTokenizer()) for _ in range(2)]
    yield [f"http://127.0.0.1:{httpd.server_address[1]}" for _, httpd in made], weights
    for fe, httpd in made:
        httpd.shutdown()
        fe.shutdown()


def _reference_outputs(config, weights, tok, prompts, max_tokens=6):
    engine = _engine(config, weights)
    for i, p in enumerate(prompts):
        engine.submit(Request(i, tok.encode(p), max_new_tokens=max_tokens,
                              eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
    out = {r.request_id: r.generated for r in engine.run()}
    return [out[i] for i in range(len(prompts))]


def test_gateway_routes_and_matches(workers):
    urls, weights = workers
    gw = connect_workers(urls, FakeTokenizer(), wait_s=30.0)
    prompts = [f"prompt number {i}" for i in range(6)]
    pendings = [gw.submit(p, max_tokens=6, seed=0) for p in prompts]
    for p in pendings:
        assert p.done.wait(timeout=300)
    assert [p.request.generated for p in pendings] == _reference_outputs(CONFIG, weights, FakeTokenizer(), prompts)
    assert all(p.request.finish_reason in ("length", "eos") for p in pendings)
    served = [c.stats().get("completed", 0) for c in gw.frontends]
    assert all(s > 0 for s in served), served
    assert sum(served) >= len(prompts)


def test_gateway_streaming(workers):
    urls, _ = workers
    pending = RemoteWorkerClient(urls[0], FakeTokenizer()).submit("stream me", max_tokens=5, stream=True)
    toks = []
    while (t := pending.tokens.get(timeout=300)) is not None:
        toks.append(t)
    assert pending.done.wait(timeout=30)
    assert toks == pending.request.generated and len(toks) >= 1
    assert pending.request.finish_reason in ("length", "eos")


def test_gateway_http_stack(workers):
    urls, weights = workers
    gw = connect_workers(urls, FakeTokenizer())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(gw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                     data=json.dumps({"prompt": "hello", "max_tokens": 4}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            body = json.load(r)
        want = _reference_outputs(CONFIG, weights, FakeTokenizer(), ["hello"], max_tokens=4)[0]
        assert body["tokens"] == len(want) and body["text"] == FakeTokenizer().decode(want)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["replicas"] == 2 and stats["completed"] == sum(s["completed"] for s in stats["per_replica"])
    finally:
        httpd.shutdown()


def test_unhealthy_worker_raises():
    with pytest.raises(TimeoutError):
        connect_workers(["http://127.0.0.1:9"], FakeTokenizer(), wait_s=0.5)


def test_worker_failures_become_the_finish_reason():
    refused = RemoteWorkerClient(f"http://127.0.0.1:{free_port()}", FakeTokenizer()).submit("x", max_tokens=2)
    assert refused.done.wait(30) and refused.request.finish_reason.startswith("error: ")
    engine = _engine(CONFIG, _weights())

    def fail():
        raise RuntimeError("the card is gone")

    engine.step = fail
    fe, httpd = _worker(engine, FakeTokenizer())
    try:
        client = RemoteWorkerClient(f"http://127.0.0.1:{httpd.server_address[1]}", FakeTokenizer())
        p = client.submit("x", max_tokens=2, stream=True)
        assert p.tokens.get(timeout=60) is None and p.done.wait(30)
        assert p.request.finish_reason == "error: RuntimeError: the card is gone"
        assert client.load == 0
    finally:
        httpd.shutdown()
        fe.shutdown()


def test_gateway_cli_answers_as_the_api(exported):  # noqa: F811
    ckpt = exported / "m.qtpu"
    config, weights = load_checkpoint(ckpt)
    tok = Tokenizer(ckpt, config.vocab_size)
    made = [_worker(ContinuousBatchingEngine(config=config, weights=weights, n_slots=2, kv_layout="paged",
                                             sampling="device", device="cpu"), tok) for _ in range(2)]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    urls = ",".join(f"http://127.0.0.1:{h.server_address[1]}" for _, h in made)
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(ckpt), "--gateway", urls,
                             "--port", str(port)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    prompts = ["hello world", "the quick brown fox"]
    try:
        for _ in range(600):
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5).read()
                break
            except OSError:
                time.sleep(0.2)
        bodies = []
        for i, prompt in enumerate(prompts):
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions",
                                         data=json.dumps({"prompt": prompt, "max_tokens": 8,
                                                          "stream": i == 1}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            if i == 1:
                chunks = [json.loads(line) for line in raw.splitlines() if line.strip()]
                assert chunks[-1]["done"] and chunks[-1]["finish_reason"] in ("length", "eos")
                bodies.append({"text": "".join(c["text"] for c in chunks[:-1]), "tokens": chunks[-1]["tokens"]})
            else:
                bodies.append(json.loads(raw))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0, proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for fe, httpd in made:
            httpd.shutdown()
            fe.shutdown()
    for prompt, body in zip(prompts, bodies):
        engine = ContinuousBatchingEngine(config=config, weights=weights, n_slots=2, kv_layout="paged",
                                          sampling="device", device="cpu")
        engine.submit(Request(0, tok.encode(prompt), max_new_tokens=8,
                              eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
        want = engine.run()[0].generated
        assert body["text"] == tok.decode(want) and body["tokens"] == len(want)
