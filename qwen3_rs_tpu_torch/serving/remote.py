"""Cross-host serving: request-level data parallelism over worker processes.

The port of the reference package's ``serving/remote.py``:

* each **worker** runs one ordinary serving process (``cli.py serve``): its
  own engine, tensor-parallel ranks over its devices, page pool and prefix
  cache;
* a **gateway** process (``cli.py serve --gateway URL,URL``) routes requests
  to the workers over a thin HTTP hop: ``RemoteWorkerClient`` speaks the
  workers' own ``/v1`` protocol and has the ``ServingFrontend`` surface, so
  the same ``ReplicatedFrontend`` routes over it (least-loaded, prefix
  affinity).  The gateway reads the checkpoint's config and tokenizer only:
  no weights, no device work.

The client always streams from its worker, so that the gateway has the
generated token ids as with a local engine (a whole completion's body
carries only text).  A worker's failure (a broken connection, or the error a
worker's stream ends with) becomes the request's ``finish_reason``,
``"error: ..."``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import types
import urllib.request
from typing import Optional

from .server import ReplicatedFrontend, _Pending

logger = logging.getLogger(__name__)


class _RemoteResult:
    """Request-shaped completion record rebuilt from the stream."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.generated: list[int] = []
        self.finish_reason: Optional[str] = None
        self.ttft: Optional[float] = None


class RemoteWorkerClient:
    """``ServingFrontend``-shaped handle of a worker server.

    ``submit()``, ``stats()``, ``load`` and ``shutdown()`` are what
    ``ReplicatedFrontend`` and ``make_handler`` use, so a gateway can put
    local engines and remote workers behind one router.  ``prefix_cache``
    says whether the worker caches prefixes (the router's affinity reads
    ``engine.prefix_cache``).
    """

    def __init__(self, base_url: str, tokenizer, timeout_s: float = 600.0, prefix_cache: bool = True):
        self.base_url = base_url.rstrip("/")
        self.tokenizer = tokenizer
        self.timeout_s = timeout_s
        self._inflight = 0
        self._lock = threading.Lock()
        self._next_id = 0
        self.engine = types.SimpleNamespace(prefix_cache=prefix_cache)

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
        with self._lock:
            req_id = self._next_id
            self._next_id += 1
            self._inflight += 1
        pending = _Pending(stream)
        pending.request = _RemoteResult(req_id)
        payload = json.dumps({
            "prompt": prompt, "max_tokens": max_tokens, "temperature": temperature, "top_p": top_p,
            "seed": seed, "stream": True,  # always stream: the gateway needs the token ids
        }).encode()

        def run():
            try:
                req = urllib.request.Request(self.base_url + "/v1/completions", data=payload,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    for raw in resp:
                        line = raw.strip()
                        if not line:
                            continue
                        obj = json.loads(line)
                        if obj.get("done"):
                            if "error" in obj:  # the worker's engine failed
                                pending.request.finish_reason = f"error: {obj['error']}"
                            else:
                                pending.request.finish_reason = obj.get("finish_reason")
                            break
                        tok = int(obj["token"])
                        pending.request.generated.append(tok)
                        if stream:
                            pending.tokens.put(tok)
            except Exception as e:  # noqa: BLE001  (the request's finish_reason carries it)
                logger.error("remote worker %s failed: %s", self.base_url, e)
                pending.request.finish_reason = f"error: {e}"
            finally:
                if stream:
                    pending.tokens.put(None)
                with self._lock:
                    self._inflight -= 1
                pending.done.set()

        threading.Thread(target=run, daemon=True).start()
        return pending

    @property
    def load(self) -> int:
        with self._lock:
            return self._inflight

    def stats(self) -> dict:
        try:
            with urllib.request.urlopen(self.base_url + "/v1/stats", timeout=30) as resp:
                return json.loads(resp.read())
        except Exception as e:  # noqa: BLE001
            return {"error": str(e), "worker": self.base_url}

    def healthy(self, timeout_s: float = 5.0) -> bool:
        try:
            with urllib.request.urlopen(self.base_url + "/health", timeout=timeout_s) as resp:
                return json.loads(resp.read()).get("status") == "ok"
        except Exception:  # noqa: BLE001
            return False

    def shutdown(self):  # the worker's lifetime is its own process's
        pass


def connect_workers(urls: list[str], tokenizer, *, wait_s: float = 0.0) -> ReplicatedFrontend:
    """The gateway: a ``ReplicatedFrontend`` routing over worker servers.
    ``wait_s`` > 0 polls each worker's ``/health`` until it answers (a
    worker builds its kernels and warms up before it serves), raising
    ``TimeoutError`` past it."""
    clients = [RemoteWorkerClient(u, tokenizer) for u in urls]
    if wait_s:
        deadline = time.monotonic() + wait_s
        for c in clients:
            while not c.healthy():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"worker {c.base_url} not healthy")
                time.sleep(0.25)
    return ReplicatedFrontend(clients)
