"""Continuous-batching serving: the engine over dense slots or the page pool
(``start_tp_engine``: over the ranks of a tensor-parallel group), the
refcounted prefix cache, the HTTP front end, the router over replicas
(``ReplicatedFrontend``) and the gateway's clients of worker servers
(``remote``)."""

from .paged_cache import (
    PageAllocator,
    PagedKVCache,
    QuantizedPagedKVCache,
    init_paged_cache,
    paged_cache_from_jax_numpy,
)
from .scheduler import ContinuousBatchingEngine, Request, RequestState, start_tp_engine
from .server import ReplicatedFrontend, ServingFrontend, make_handler, render_chat, serve

__all__ = [
    "ContinuousBatchingEngine",
    "Request",
    "RequestState",
    "start_tp_engine",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedPagedKVCache",
    "init_paged_cache",
    "paged_cache_from_jax_numpy",
    "ServingFrontend",
    "ReplicatedFrontend",
    "make_handler",
    "render_chat",
    "serve",
]
