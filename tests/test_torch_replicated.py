"""Replicated serving: the port's ``ReplicatedFrontend`` and ``serve
--replicas``.

* Routing: the port's router and the JAX package's over the same stub front
  ends and the same scripted loads choose the same replica at every step:
  least-loaded with reservations, prefix affinity within and beyond the
  slack, the LRU cap of the affinity map.
* Two engines of the port behind the router and the HTTP front end:
  concurrent greedy requests answer as one engine does, both replicas take
  requests, the stats sum over them; with prefix caching, prompts that share
  a head go to one replica and hit its cache.
* ``cli.py serve --replicas 2 --device cpu,cpu`` (engines in the process)
  and ``--replicas 2 --tp 2 --device cpu,cpu,cpu,cpu`` (a ``serve --tp 2``
  process a replica) in processes of their own: a completion equal to the
  API's, and SIGTERM leaves no process behind.
"""

import functools
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

import numpy as np
import pytest
import torch

from test_torch_server import CONFIG, FakeTokenizer
from test_torch_tp import _children, tp_checkpoint  # noqa: F401  (the dim-256, 2-kv-head checkpoint)
from torch_parity import jax_numpy_weights

from qwen3_rs_tpu.serving.server import ReplicatedFrontend as JaxReplicatedFrontend
from qwen3_rs_tpu_torch.checkpoint import load_checkpoint
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.configuration import read_config
from qwen3_rs_tpu_torch.inference.tokenizer import Tokenizer
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy
from qwen3_rs_tpu_torch.parallel.distributed import free_port
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, ReplicatedFrontend, Request, ServingFrontend
from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine
from qwen3_rs_tpu_torch.serving.server import make_handler

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------- routing
class _Stub:
    """A front end of scripted load that records its submits."""

    def __init__(self, prefix_cache):
        self.load = 0
        self.engine = type("E", (), {"prefix_cache": prefix_cache})()
        self.tokenizer = FakeTokenizer()
        self.calls = 0

    def submit(self, prompt, **kw):
        self.calls += 1
        self.load += 1
        return object()

    def stats(self):
        return {"completed": self.calls - self.load, "slot_utilization": 0.5, "p50_ttft": 0.01 * self.calls}


def _script(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    heads = ["You are a helpful assistant. " * 10, "Summarize the text below. " * 12, "x" * 300, ""]
    steps = []
    for _ in range(n):
        kind = rng.choice(["submit", "submit", "done", "reserve"])
        if kind == "submit":
            steps.append(("submit", heads[rng.integers(len(heads))] + f"q{rng.integers(6)}"))
        else:
            steps.append((kind, int(rng.integers(3))))
    return steps


@pytest.mark.parametrize("prefix_cache,slack,cap", [(False, 4, 4096), (True, 4, 4096), (True, 1, 4096),
                                                     (True, 2, 3)])
def test_routing_matches_jax(prefix_cache, slack, cap):
    routers = []
    for cls in (ReplicatedFrontend, JaxReplicatedFrontend):
        r = cls([_Stub(prefix_cache) for _ in range(3)], affinity_slack=slack)
        r._affinity_cap = cap
        routers.append(r)
    assert (routers[0]._affinity is None) == (routers[1]._affinity is None) == (not prefix_cache)
    for step, (kind, arg) in enumerate(_script(slack * 7 + cap)):
        for r in routers:
            if kind == "submit":
                r.submit(arg)
            elif kind == "done":
                f = r.frontends[arg]
                f.load = max(0, f.load - 1)
            else:  # a submit routed and not yet queued, as a concurrent one is
                r._reserved = [int(i == arg) for i in range(3)]
        port, ref = ([f.calls for f in r.frontends] for r in routers)
        assert port == ref, (step, kind, arg)
        if prefix_cache:
            assert list(routers[0]._affinity.items()) == list(routers[1]._affinity.items())
            assert len(routers[0]._affinity) <= cap
    assert routers[0].stats() == routers[1].stats()
    assert routers[0].AFFINITY_CHARS == JaxReplicatedFrontend.AFFINITY_CHARS == 256


def test_routing_needs_a_replica():
    with pytest.raises(ValueError, match="at least one replica"):
        ReplicatedFrontend([])


# ---------------------------------------------------------------- two engines
class LongTokenizer(FakeTokenizer):
    """One token a character, the whole prompt (FakeTokenizer keeps 8)."""

    def encode(self, text):
        return [3 + (ord(c) % 90) for c in text] or [3]


def _engine(**kw):
    weights = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 5, fast_scales=False))
    return ContinuousBatchingEngine(config=CONFIG, weights=weights, n_slots=2, prefill_buckets=(8, 16),
                                    kv_layout="paged", page_size=16, device="cpu", **kw)


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.load(r)


@pytest.fixture(scope="module")
def replicated():
    fes = [ServingFrontend(_engine(), FakeTokenizer()) for _ in range(2)]
    rf = ReplicatedFrontend(fes)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(rf))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield rf, httpd.server_address[1]
    httpd.shutdown()
    rf.shutdown()


def test_replicas_answer_as_one_engine(replicated):
    rf, port = replicated
    prompts = [f"prompt {i}" for i in range(6)]
    one = _engine()
    tok = FakeTokenizer()
    for i, p in enumerate(prompts):
        one.submit(Request(i, tok.encode(p), max_new_tokens=6, eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
    want = {r.request_id: tok.decode(r.generated) for r in one.run()}
    got = [None] * len(prompts)

    def go(i):
        got[i] = _post(port, {"prompt": prompts[i], "max_tokens": 6})["text"]

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert got == [want[i] for i in range(len(prompts))]
    stats = rf.stats()
    assert stats["replicas"] == 2 and len(stats["load"]) == 2
    per = [s["completed"] for s in stats["per_replica"]]
    assert all(n > 0 for n in per), per  # both replicas took requests
    assert stats["completed"] == sum(per) >= len(prompts)


def test_prefix_affinity_hits_one_replica_cache():
    """Prompts sharing a head longer than AFFINITY_CHARS go to the replica
    that computed it, whose prefix cache they hit, one after the other."""
    from dataclasses import replace

    cfg = replace(CONFIG, seq_len=512)
    weights = weights_from_jax_numpy(jax_numpy_weights(cfg, 5, fast_scales=False))
    engines = [ContinuousBatchingEngine(config=cfg, weights=weights, n_slots=2, kv_layout="paged", page_size=16,
                                        n_pages=80, prefix_cache=True, device="cpu") for _ in range(2)]
    rf = ReplicatedFrontend([ServingFrontend(e, LongTokenizer()) for e in engines])
    try:
        head = "You are a helpful assistant who answers briefly. " * 6
        assert len(head) > ReplicatedFrontend.AFFINITY_CHARS
        for i in range(4):
            p = rf.submit(head + f"question {i}", max_tokens=2)
            assert p.done.wait(120) and p.error is None
        hits = [e.stats()["prefix_hits"] for e in engines]
        done = [e.stats()["completed"] for e in engines]
    finally:
        rf.shutdown()
    assert sorted(done) == [0, 4] and sorted(hits) == [0, 3], (done, hits)


# ----------------------------------------------------------------------- CLI
def _descendants(pid: int) -> list[int]:
    out, todo = [], [pid]
    while todo:
        kids = _children(todo.pop())
        out += kids
        todo += kids
    return out


def _serve_cli(ckpt, flags) -> dict:
    """Start ``cli.py serve`` with ``flags`` in a process of its own, post one
    completion, SIGTERM it; returns the body and the processes it ran."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen([sys.executable, "-m", "qwen3_rs_tpu_torch.cli", "serve", str(ckpt), "--slots", "2",
                             "--port", str(port), *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        for _ in range(1200):
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5).read()
                break
            except OSError:
                time.sleep(0.2)
        body = _post(port, {"prompt": "hello world", "max_tokens": 6})
        procs = _descendants(proc.pid)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(120) == 0, proc.stdout.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    for _ in range(100):
        if not any(Path(f"/proc/{p}").exists() for p in procs):
            break
        time.sleep(0.1)
    assert not any(Path(f"/proc/{p}").exists() for p in procs), "a process outlived the server"
    return {"body": body, "procs": procs}


@pytest.mark.parametrize("tp", [1, 2])
def test_serve_replicas_cli_answers_as_the_api_and_stops_cleanly(tp_checkpoint, tp):  # noqa: F811
    flags = ["--replicas", "2", "--tp", str(tp), "--device", ",".join(["cpu"] * 2 * tp)]
    run = _serve_cli(tp_checkpoint, flags)
    if tp > 1:
        # Two replica processes, each with its worker rank.
        assert len(run["procs"]) >= 4, run["procs"]
    tok = Tokenizer(tp_checkpoint, read_config(tp_checkpoint).vocab_size)
    kw = dict(n_slots=2, kv_layout="paged", sampling="device")
    if tp == 1:
        config, weights = load_checkpoint(tp_checkpoint)
        engine = ContinuousBatchingEngine(config=config, weights=weights, device="cpu", **kw)
    else:
        engine = start_tp_engine(functools.partial(load_checkpoint, tp_checkpoint), ["cpu", "cpu"], **kw)
    try:
        engine.submit(Request(0, tok.encode("hello world"), max_new_tokens=6,
                              eos_token_ids=(tok.bos_token_id, tok.eos_token_id)))
        want = engine.run()[0].generated
    finally:
        engine.close()
    assert run["body"]["text"] == tok.decode(want) and run["body"]["tokens"] == len(want)


def test_serve_replicas_need_a_device_each(tp_checkpoint):  # noqa: F811
    with pytest.raises(SystemExit, match="--replicas 2 x --tp 2 needs 4 devices, have 3"):
        port_main(["serve", str(tp_checkpoint), "--replicas", "2", "--tp", "2", "--device", "cpu,cpu,cpu"])
