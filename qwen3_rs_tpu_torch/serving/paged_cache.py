"""Paged KV cache: a fixed page pool and per-slot page tables.

The port of the reference package's ``serving/paged_cache.py``.  The dense
serving cache reserves ``seq_len`` rows per slot; the paged layout backs every
slot with one shared pool instead:

* one **page pool** stacked over layers, ``[L, P, n_kv, page_size, head_dim]``
  (an INT8 pool adds per-row scales ``[L, P, n_kv, page_size]``);
* a host-side **allocator** hands pages to requests (an admission reserves the
  pages its prompt and token budget can reach) and reclaims them when the
  request finishes, so resident KV memory tracks the tokens in flight;
* the device sees only a ``[B, max_pages]`` int32 **page table** per step:
  cache row t of slot b is row ``t % page`` of page ``table[b, t // page]``.

Page 0 is the null page: unused table entries point at it, and padding rows
write there; no request reads it below its position.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..configuration import ModelConfig
from ..device import resolve_device
from ..models.qwen3 import _from_numpy


class PagedKVCache(NamedTuple):
    """Device half of the paged cache (the host bookkeeping lives in
    :class:`PageAllocator`)."""

    k: torch.Tensor  # [L, P, n_kv, page, hd]
    v: torch.Tensor  # [L, P, n_kv, page, hd]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


class QuantizedPagedKVCache(NamedTuple):
    """INT8 page pool: codes plus one symmetric f32 scale per cached row and
    head, quantized when the row is written."""

    k: torch.Tensor  # int8 [L, P, n_kv, page, hd]
    v: torch.Tensor  # int8 [L, P, n_kv, page, hd]
    k_scale: torch.Tensor  # f32 [L, P, n_kv, page]
    v_scale: torch.Tensor  # f32 [L, P, n_kv, page]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


def init_paged_cache(
    config: ModelConfig,
    n_pages: int,
    page_size: int = 128,
    dtype=torch.bfloat16,
    device=None,
) -> PagedKVCache | QuantizedPagedKVCache:
    """Zeroed pool on ``device`` (the card unless the caller asks for the
    CPU); ``dtype="int8"`` builds the quantized pool."""
    dev = resolve_device(device)
    shape = (config.n_layers, n_pages, config.n_kv_heads, page_size, config.head_dim)
    if dtype in ("int8", torch.int8):
        return QuantizedPagedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape, dtype=torch.int8, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
            torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
        )
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)
    )


def paged_cache_from_jax_numpy(tree) -> PagedKVCache | QuantizedPagedKVCache:
    """The reference package's page pool with numpy leaves → the port's
    (CPU tensors, same layout, same values)."""
    if hasattr(tree, "k_scale"):
        return QuantizedPagedKVCache(*(_from_numpy(a) for a in (tree.k, tree.v, tree.k_scale, tree.v_scale)))
    return PagedKVCache(_from_numpy(tree.k), _from_numpy(tree.v))


class PageAllocator:
    """Host-side free-list allocator and per-slot page tables, with
    refcounted **prefix caching**: requests that share a prompt prefix share
    the pages that cover it.

    * Every page a request holds carries a refcount; a page shared by k
      requests is freed when the last of them releases it.
    * An index maps the **chain hash** of the token prefix covered by each
      fully written prompt page to that page.  Every chain starts at
      position 0, so equal chains mean identical page contents (same model,
      same tokens, same RoPE positions).
    * Released pages that are still indexed park in an LRU **cached** set
      instead of the free list: a later prompt can still adopt them, and an
      allocation that finds the free list empty reclaims (and de-indexes)
      the least recently released one.

    Same calls, same tables as the reference package's allocator: the free
    list, the chain hash and the eviction order are kept exactly.
    """

    def __init__(self, n_pages: int, n_slots: int, max_pages_per_slot: int):
        if n_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.max_pages_per_slot = max_pages_per_slot
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() → low ids first
        self.tables = np.zeros((n_slots, max_pages_per_slot), np.int32)
        self.used = np.zeros(n_slots, np.int32)  # pages held per slot
        self.refcount = np.zeros(n_pages, np.int32)
        self._index: dict[int, int] = {}  # prefix chain hash → page id
        self._page_key: dict[int, int] = {}  # page id → its chain hash
        self._cached: OrderedDict[int, None] = OrderedDict()  # zero refs, evictable

    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free plus evictable cached."""
        return len(self._free) + len(self._cached)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def can_admit(self, n_tokens: int, page_size: int) -> bool:
        need = -(-max(n_tokens, 1) // page_size)
        return need <= self.free_pages

    def _take_free(self) -> int:
        if self._free:
            return self._free.pop()
        # Evict the least recently released cached page (its index entry goes
        # with it; no live request holds it).
        pid, _ = self._cached.popitem(last=False)
        del self._index[self._page_key.pop(pid)]
        return pid

    def allocate(self, slot: int, n: int) -> list[int]:
        """Append ``n`` fresh (private, ref 1) pages to the slot's table."""
        if n > self.free_pages:
            raise RuntimeError(f"page pool exhausted: need {n}, have {self.free_pages} free")
        start = int(self.used[slot])
        if start + n > self.max_pages_per_slot:
            raise RuntimeError(f"slot {slot} exceeds max_pages_per_slot")
        pages = [self._take_free() for _ in range(n)]
        self.tables[slot, start : start + n] = pages
        self.used[slot] += n
        self.refcount[pages] = 1
        return pages

    def ensure_capacity(self, slot: int, n_tokens: int, page_size: int) -> None:
        """Grow the slot's table to cover ``n_tokens`` rows."""
        need = -(-max(n_tokens, 1) // page_size)
        have = int(self.used[slot])
        if need > have:
            self.allocate(slot, need - have)

    def release(self, slot: int) -> None:
        held = self.tables[slot, : int(self.used[slot])]
        for p in (int(x) for x in held):
            if p == 0:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] > 0:
                continue
            if p in self._page_key:
                # Indexed prefix page: keep its contents adoptable (LRU).
                self._cached[p] = None
                self._cached.move_to_end(p)
            else:
                self._free.append(p)
        self.tables[slot, :] = 0
        self.used[slot] = 0

    # --------------------------------------------------------- prefix cache
    @staticmethod
    def _chain(key: int, block) -> int:
        return hash((key,) + tuple(int(t) for t in block))

    def match_prefix(self, tokens, page_size: int) -> tuple[list[int], int]:
        """Longest indexed prefix of ``tokens`` in whole pages: (page ids, rows
        covered).  At least one trailing token is always left unmatched, so
        that the admission prefill has a window whose last row gives the
        first token's logits."""
        pages: list[int] = []
        key = 0
        max_full = (len(tokens) - 1) // page_size
        for j in range(max_full):
            key = self._chain(key, tokens[j * page_size : (j + 1) * page_size])
            pid = self._index.get(key)
            if pid is None:
                break
            pages.append(pid)
        return pages, len(pages) * page_size

    def adopt(self, slot: int, pages: list[int]) -> None:
        """Put shared prefix pages at the head of a fresh slot's table and pin
        them (ref + 1).  Must precede any ``allocate`` for the slot."""
        if int(self.used[slot]):
            raise RuntimeError("adopt() requires an empty slot table")
        if len(pages) > self.max_pages_per_slot:
            raise RuntimeError(f"slot {slot} exceeds max_pages_per_slot")
        for p in pages:
            if self.refcount[p] == 0:
                self._cached.pop(p)  # pinned again; stays indexed
            self.refcount[p] += 1
        self.tables[slot, : len(pages)] = pages
        self.used[slot] = len(pages)

    def register_prefix(self, slot: int, tokens, page_size: int) -> int:
        """Index the slot's pages that the prompt covers entirely, for reuse.

        Called once per admission with the request's whole prompt; pages the
        slot adopted are already indexed and are skipped.  Only pages whose
        every row is a prompt token register: the trailing partial page keeps
        taking decode writes and is never shared.  Returns the number of
        newly indexed pages."""
        key = 0
        fresh = 0
        n_full = min((len(tokens) - 1) // page_size, int(self.used[slot]))
        for j in range(n_full):
            key = self._chain(key, tokens[j * page_size : (j + 1) * page_size])
            if key in self._index:
                continue
            pid = int(self.tables[slot, j])
            if pid == 0 or pid in self._page_key:
                continue
            self._index[key] = pid
            self._page_key[pid] = key
            fresh += 1
        return fresh
