"""Continuous-batching serving: the engine over dense slots or the page pool,
the refcounted prefix cache, and the HTTP front end."""

from .paged_cache import (
    PageAllocator,
    PagedKVCache,
    QuantizedPagedKVCache,
    init_paged_cache,
    paged_cache_from_jax_numpy,
)
from .scheduler import ContinuousBatchingEngine, Request, RequestState
from .server import ServingFrontend, make_handler, render_chat, serve

__all__ = [
    "ContinuousBatchingEngine",
    "Request",
    "RequestState",
    "PageAllocator",
    "PagedKVCache",
    "QuantizedPagedKVCache",
    "init_paged_cache",
    "paged_cache_from_jax_numpy",
    "ServingFrontend",
    "make_handler",
    "render_chat",
    "serve",
]
