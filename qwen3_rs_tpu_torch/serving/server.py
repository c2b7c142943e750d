"""Minimal HTTP front end over the continuous-batching engine.

The port of the reference package's ``serving/server.py`` (stdlib
``http.server``, no dependencies), with the same endpoints and JSON:

* ``POST /v1/completions``: ``{"prompt": str, "max_tokens": int,
  "temperature": float, "top_p": float, "seed": int}`` → one JSON object with
  the completion or, with ``"stream": true``, newline-delimited JSON chunks
  as tokens are emitted;
* ``POST /v1/chat/completions``: ``{"messages": [{"role": "system" | "user" |
  "assistant", "content": str}, ...], ...}`` rendered through the
  checkpoint's ``%s`` templates as the interactive chat loop renders them;
  the answer carries ``{"message": {"role": "assistant", "content": ...}}``;
* ``GET /v1/stats``: the scheduler's counters;
* ``GET /health``.

One worker thread owns the engine (it is not thread-safe); handler threads
talk to it through queues.  The worker runs the engine on its device's
current stream.  If a step raises, the worker stops: every request in flight
and every later one fails with the error (HTTP 500), nothing is dropped
silently.

``ReplicatedFrontend`` routes each request to the least-loaded of several
front ends (engine replicas, or ``serving.remote`` clients of worker
servers), with prefix affinity when the engines cache prefixes; the HTTP
layer serves it unchanged.

A tensor-parallel engine (``start_tp_engine``) is driven from rank 0 as any
other; its worker ranks run behind it.  While idle the worker sends them a
heartbeat, and ``shutdown()`` stops and joins them.  ``failed`` is set when
the engine fails, so that a caller can stop serving (``cli.py serve --tp``
exits non-zero).
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from ..inference.generation import render_prompt
from ..inference.tokenizer import Utf8StreamDecoder
from .scheduler import ContinuousBatchingEngine, Request

logger = logging.getLogger(__name__)


class _Pending:
    def __init__(self, stream: bool):
        self.stream = stream
        self.tokens: "queue.Queue[Optional[int]]" = queue.Queue()
        self.done = threading.Event()
        self.request: Optional[Request] = None
        self.error: Optional[str] = None  # the engine's failure, if it failed


def render_chat(messages: list[dict], tokenizer) -> str:
    """Render an OpenAI-style message list through the checkpoint's ``%s``
    templates as the interactive chat loop does (``render_prompt``): the first
    user turn carries the system prompt (if any), later user turns take the
    plain template, and assistant turns are appended verbatim (the chat loop
    never feeds the assistant's EOS back either)."""
    system: Optional[str] = None
    parts: list[str] = []
    first_user = True
    for m in messages:
        role, content = m["role"], m["content"]
        if role == "system":
            system = content
        elif role == "user":
            parts.append(
                render_prompt(0 if first_user else 1, system if first_user else None, content, tokenizer)
            )
            first_user = False
        elif role == "assistant":
            parts.append(content)
        else:
            raise ValueError(f"unknown role: {role!r}")
    if first_user:
        raise ValueError("messages must contain at least one user turn")
    return "".join(parts)


class ServingFrontend:
    """Owns the engine's worker thread and the request plumbing."""

    def __init__(self, engine: ContinuousBatchingEngine, tokenizer, poll_idle_s=0.005):
        self.engine = engine
        self.tokenizer = tokenizer
        self._submissions: "queue.Queue[tuple[Request, _Pending]]" = queue.Queue()
        self._pending: dict[int, _Pending] = {}
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._poll_idle_s = poll_idle_s
        self._running = True
        self._completed_seen = 0
        self.error: Optional[str] = None  # set when an engine step raised
        self.failed = threading.Event()  # and set with it
        dev = engine.device  # the worker launches on the engine's card ("cuda": this thread's)
        self._cuda_index = None if dev.type != "cuda" else (
            dev.index if dev.index is not None else torch.cuda.current_device())
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- client api
    def submit(
        self,
        prompt: str,
        *,
        max_tokens: int = 128,
        temperature: float = 0.0,
        top_p: float = 0.9,
        seed: int = 0,
        stream: bool = False,
    ) -> _Pending:
        with self._id_lock:
            req_id = self._next_id
            self._next_id += 1
        req = Request(
            request_id=req_id,
            prompt_tokens=self.tokenizer.encode(prompt),
            max_new_tokens=max_tokens,
            temperature=temperature,
            topp=top_p,
            seed=seed,
            eos_token_ids=(self.tokenizer.bos_token_id, self.tokenizer.eos_token_id),
        )
        pending = _Pending(stream)
        self._submissions.put((req, pending))
        if self.error is not None:  # the worker is gone: fail whatever it left queued
            self._fail_queued()
        return pending

    def stats(self) -> dict:
        return self.engine.stats()

    @property
    def load(self) -> int:
        """Requests submitted and not yet completed (queued and in flight)."""
        return self._submissions.qsize() + len(self._pending)

    def shutdown(self):
        """Stop the worker thread; a tensor-parallel engine's worker ranks
        stop with it."""
        self._running = False
        self._thread.join(timeout=10)
        self.engine.close(force=self._thread.is_alive())

    # ---------------------------------------------------------------- worker
    def _worker(self):
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            while self._running:
                self._serve_once()
        except Exception as e:  # an engine failure fails its requests, never silently
            logger.exception("serving engine failed")
            self.error = f"{type(e).__name__}: {e}"
            self.failed.set()
            for p in self._pending.values():
                self._fail(p)
            self._pending.clear()
            self._fail_queued()

    def _serve_once(self):
        admitted = False
        while True:
            try:
                req, pending = self._submissions.get_nowait()
            except queue.Empty:
                break
            self._pending[req.request_id] = pending
            pending.request = req
            self.engine.submit(req)
            admitted = True
        if self.engine.has_work:
            for req, token in self.engine.step():
                p = self._pending.get(req.request_id)
                if p is not None and p.stream:
                    p.tokens.put(token)
            done = self.engine.completed
            while self._completed_seen < len(done):
                req = done[self._completed_seen]
                self._completed_seen += 1
                p = self._pending.pop(req.request_id, None)
                if p is not None:
                    p.request = req
                    if p.stream:
                        p.tokens.put(None)  # sentinel
                    p.done.set()
        elif not admitted:
            self.engine.heartbeat()
            time.sleep(self._poll_idle_s)

    def _fail(self, p: _Pending) -> None:
        p.error = self.error
        if p.stream:
            p.tokens.put(None)
        p.done.set()

    def _fail_queued(self) -> None:
        while True:
            try:
                req, pending = self._submissions.get_nowait()
            except queue.Empty:
                return
            pending.request = req
            self._fail(pending)


class ReplicatedFrontend:
    """Request-level data parallelism: route each request to the least-loaded
    of N front ends.

    Each replica is an engine of its own (weights, page pool, scheduler) on
    its own device or devices (``serve --replicas R``), or a worker server
    behind a ``serving.remote.RemoteWorkerClient`` (``serve --gateway``, and
    the tensor-parallel replicas of ``serve --replicas R --tp K``); replicas
    share nothing, so nothing on the hot path synchronises them.  Exposes
    the surface ``make_handler`` needs (submit, stats, tokenizer, shutdown).
    """

    #: characters of the prompt head that define a routing-affinity key.  It
    #: must sit inside the shared prefix to bring its requests together, so it
    #: errs short: merging too much only brings more together (bounded by the
    #: slack); merging too little loses every hit across requests.  256
    #: characters are about half a default 128-token page.
    AFFINITY_CHARS = 256

    def __init__(self, frontends: list, affinity_slack: int = 4):
        if not frontends:
            raise ValueError("need at least one replica")
        self.frontends = frontends
        self.tokenizer = frontends[0].tokenizer
        self._lock = threading.Lock()
        # Routed but not yet queued: submit() tokenizes the prompt outside the
        # lock, which covers only the choice of replica, so these reservations
        # keep concurrent submits from all landing on the same replica.
        self._reserved = [0] * len(frontends)
        # Prefix affinity: each replica's page pool is its own, so a request
        # sharing a prefix hits the prefix cache only on the replica that
        # computed it.  When the engines cache prefixes, prompts with the same
        # head go to a sticky replica unless it is more than
        # ``affinity_slack`` requests busier than the least-loaded one.
        self._affinity_slack = affinity_slack
        self._affinity: "OrderedDict[int, int] | None" = (
            OrderedDict()
            if any(getattr(getattr(f, "engine", None), "prefix_cache", False) for f in frontends)
            else None
        )
        self._affinity_cap = 4096  # an LRU bound for long-lived servers

    def _route(self, prompt: str) -> int:
        loads = [self.frontends[j].load + self._reserved[j] for j in range(len(self.frontends))]
        best = min(range(len(loads)), key=loads.__getitem__)
        if self._affinity is None:
            return best
        key = hash(prompt[: self.AFFINITY_CHARS])
        sticky = self._affinity.get(key)
        if sticky is not None and loads[sticky] - loads[best] <= self._affinity_slack:
            self._affinity.move_to_end(key)
            return sticky
        self._affinity[key] = best
        self._affinity.move_to_end(key)
        while len(self._affinity) > self._affinity_cap:
            self._affinity.popitem(last=False)
        return best

    def submit(self, prompt: str, **kwargs) -> _Pending:
        with self._lock:
            i = self._route(prompt)
            self._reserved[i] += 1
        try:
            return self.frontends[i].submit(prompt, **kwargs)
        finally:
            with self._lock:
                self._reserved[i] -= 1

    def stats(self) -> dict:
        per = [f.stats() for f in self.frontends]
        agg = {"replicas": len(per), "per_replica": per, "load": [f.load for f in self.frontends]}
        # The counters that sum are summed; the utilization is averaged.
        for key in ("completed", "kv_pages_total", "kv_pages_free"):
            if all(key in s for s in per):
                agg[key] = sum(s[key] for s in per)
        if all("slot_utilization" in s for s in per):
            agg["slot_utilization"] = sum(s["slot_utilization"] for s in per) / len(per)
        ttfts = [s["p50_ttft"] for s in per if s.get("p50_ttft")]
        agg["p50_ttft"] = sorted(ttfts)[len(ttfts) // 2] if ttfts else None
        return agg

    def shutdown(self):
        for f in self.frontends:
            f.shutdown()


def make_handler(frontend: ServingFrontend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _chunk(self, obj) -> None:
            data = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._json(200, frontend.stats())
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            chat = self.path == "/v1/chat/completions"
            if self.path != "/v1/completions" and not chat:
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if chat:
                    prompt = render_chat(payload["messages"], frontend.tokenizer)
                else:
                    prompt = payload["prompt"]
            except (json.JSONDecodeError, KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            pending = frontend.submit(
                prompt,
                max_tokens=int(payload.get("max_tokens", 128)),
                temperature=float(payload.get("temperature", 0.0)),
                top_p=float(payload.get("top_p", 0.9)),
                seed=int(payload.get("seed", 0)),
                stream=bool(payload.get("stream", False)),
            )
            if pending.stream:
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                decoder = Utf8StreamDecoder()
                while True:
                    token = pending.tokens.get()
                    if token is None:
                        break
                    piece = decoder.push(frontend.tokenizer.decode_bytes(token))
                    self._chunk({"token": token, "text": piece})
                req = pending.request
                if pending.error is not None:
                    self._chunk({"done": True, "error": pending.error})
                else:
                    self._chunk({"done": True, "finish_reason": req.finish_reason, "tokens": len(req.generated)})
                self.wfile.write(b"0\r\n\r\n")
                return
            pending.done.wait()
            if pending.error is not None:
                self._json(500, {"error": pending.error})
                return
            req = pending.request
            text = frontend.tokenizer.decode(req.generated)
            body = {"tokens": len(req.generated), "finish_reason": req.finish_reason, "ttft_s": req.ttft}
            if chat:
                body["message"] = {"role": "assistant", "content": text}
            else:
                body["text"] = text
            self._json(200, body)

    return Handler


class _Server(ThreadingHTTPServer):
    # The stdlib's listen backlog of 5 resets connections of a burst of
    # clients that arrive before the accept loop takes them.
    request_queue_size = 128


def serve(frontend: ServingFrontend, host: str = "127.0.0.1", port: int = 8000, *, ready=None):
    """Blocking server loop.  ``ready(httpd)``, if given, is called once the
    socket is bound (``httpd.server_address`` holds the port when ``port`` is
    0; ``httpd.shutdown()`` from another thread ends the loop)."""
    httpd = _Server((host, port), make_handler(frontend))
    logger.info("serving on http://%s:%d", *httpd.server_address[:2])
    if ready is not None:
        ready(httpd)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        frontend.shutdown()
