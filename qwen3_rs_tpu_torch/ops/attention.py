"""Grouped-query attention over a cached prefix plus the current window.

Plain PyTorch; it serves the continuation prefill windows and every window
of the exact and f32 modes (the reference package computes those outside any
Pallas kernel too), over the dense cache or, with the cache chunks gathered
by page id, over the serving page pool.  Fast-mode decode steps (S = 1) go
through the flash-decode kernel (``ops/kernels/flash_attention.py``) or, on
the pool, the paged decode kernel (``ops/kernels/paged_attention.py``);
short paged windows through the paged window kernel; fresh fast-mode
windows of more than 256 rows through the causal prefill kernel
(``ops/kernels/prefill_attention.py``).

Conventions, as in the reference package:
* queries  q:      [B, S, n_heads, head_dim]
* cache    k, v:   [B, n_kv_heads, T, head_dim] — rows t < pos_start[b] valid
  (the pool: [P, n_kv_heads, page, head_dim] and a [B, max_pages] page table)
* window   k/v:    [B, S, n_kv_heads, head_dim]
* scale 1/sqrt(head_dim); softmax in f32; query head h reads kv head
  ``h // (n_heads // n_kv_heads)``.

Long windows run in query chunks of ``QUERY_CHUNK`` rows, each reading only
the window keys at or below its last row; the cache prefix is read in chunks
of ``CACHE_KEY_CHUNK`` rows with an online softmax.  The score tensor stays
at ``[B, n_heads, QUERY_CHUNK, CACHE_KEY_CHUNK]`` however deep the context.
"""

from __future__ import annotations

import numpy as np
import torch

QUERY_CHUNK = 512
CACHE_KEY_CHUNK = 4096


def merge_softmax_partials(m1, l1, a1, m2, l2, a2):
    """Combine two online-softmax partial triples (max, sum, acc) in f32:
    the guarded rescale-and-add rule.  A fully masked part carries ``m =
    -inf`` and contributes exactly zero (the guard keeps ``exp(-inf - -inf)``
    from making a NaN)."""
    m = torch.maximum(m1, m2)
    r1 = torch.where(torch.isfinite(m1), torch.exp(m1 - m), 0.0)
    r2 = torch.where(torch.isfinite(m2), torch.exp(m2 - m), 0.0)
    return m, l1 * r1 + l2 * r2, a1 * r1 + a2 * r2


def gqa_attention_split(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos_start,
    *,
    k_scale_cache: torch.Tensor | None = None,
    v_scale_cache: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal GQA attention with one softmax over the cache prefix and the
    window.

    ``pos_start`` holds the host-side window offsets ([B] ints): only rows
    below ``max(pos_start)`` of the cache are read, and row t of request b
    takes part iff ``t < pos_start[b]``.  ``k/v_scale_cache`` ([B, kv, T])
    dequantize an INT8 cache as it is read.  Returns [B, S, n_heads, hd] in
    ``q.dtype``.
    """

    def fetch(t0, t1):
        kc = k_cache[:, :, t0:t1].float()
        vc = v_cache[:, :, t0:t1].float()
        if k_scale_cache is not None:
            kc = kc * k_scale_cache[:, :, t0:t1, None]
            vc = vc * v_scale_cache[:, :, t0:t1, None]
        return kc, vc

    return _split_attention(q, fetch, CACHE_KEY_CHUNK, k_new, v_new, pos_start)


def gqa_attention_split_paged(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    pos_start,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`gqa_attention_split` over one layer's page pool
    ``[P, n_kv, page, hd]``: cache row t of request b is row ``t % page`` of
    page ``page_table[b, t // page]`` ([B, max_pages] ints).  The cache
    chunks are gathered from the pool by page id (whole pages, a multiple of
    ``page`` rows each); ``k/v_scale_pool`` ([P, n_kv, page]) dequantize an
    INT8 pool as it is read.  Returns [B, S, n_heads, hd] in ``q.dtype``."""
    page = k_pool.shape[2]
    table = torch.as_tensor(page_table, device=q.device)

    def fetch(t0, t1):
        def rows(pool):
            return gather_pages(pool, table, t0 // page, -(-t1 // page))[:, :, : t1 - t0]

        kc, vc = rows(k_pool).float(), rows(v_pool).float()
        if k_scale_pool is not None:
            kc = kc * rows(k_scale_pool)[..., None]
            vc = vc * rows(v_scale_pool)[..., None]
        return kc, vc

    chunk = page * max(1, CACHE_KEY_CHUNK // page)
    return _split_attention(q, fetch, chunk, k_new, v_new, pos_start)


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor, j0: int, j1: int) -> torch.Tensor:
    """Table entries j0..j1 of each request, gathered from one layer's pool
    ``[P, n_kv, page, ...]`` (rows, or an INT8 pool's row scales) →
    ``[B, n_kv, (j1 - j0)·page, ...]``: request b's cache rows
    ``j0·page .. j1·page``."""
    g = pool[page_table[:, j0:j1].long()].transpose(1, 2)  # [B, n_kv, pages, page, ...]
    return g.reshape(*g.shape[:2], -1, *g.shape[4:])


def _split_attention(q, fetch, chunk: int, k_new, v_new, pos_start) -> torch.Tensor:
    """The cache part (``fetch(t0, t1)`` reads rows [t0, t1) in ``chunk``-row
    steps) merged with the window's causal part, in query chunks."""
    b, s, n_heads, hd = q.shape
    n_kv = k_new.shape[2]
    qf = q.reshape(b, s, n_kv, n_heads // n_kv, hd).float()
    pos_np = np.asarray(pos_start, np.int64).reshape(b)
    outs = []
    for c0 in range(0, s, QUERY_CHUNK):
        c1 = min(s, c0 + QUERY_CHUNK)
        m_c, l_c, acc_c = _cache_part(qf[:, c0:c1], fetch, chunk, pos_np)
        outs.append(_merge_window(qf[:, c0:c1], m_c, l_c, acc_c, k_new[:, :c1], v_new[:, :c1], c0))
    out = torch.cat(outs, dim=3)  # [B, KV, M, S, hd]
    # [B, KV, M, S, hd] → [B, S, KV, M, hd] → [B, S, n_heads, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, n_heads, hd).to(q.dtype)


def _cache_part(qf, fetch, chunk: int, pos_np):
    """Online softmax over the valid cache rows: (max, sum, acc) with shapes
    [B, KV, M, Sq, 1], [B, KV, M, Sq, 1], [B, KV, M, Sq, hd]; the max is -inf
    where a request has no cache row.  ``fetch(t0, t1)`` returns the rows
    [t0, t1) as f32 ``(k, v)`` [B, KV, t1 - t0, hd], dequantized."""
    b, sq, n_kv, kv_mul, hd = qf.shape
    dev = qf.device
    scale = 1.0 / (hd**0.5)
    m = torch.full((b, n_kv, kv_mul, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, n_kv, kv_mul, sq, 1), device=dev)
    acc = torch.zeros((b, n_kv, kv_mul, sq, hd), device=dev)
    pos_t = torch.as_tensor(pos_np, device=dev)
    p_max = int(pos_np.max())
    for t0 in range(0, p_max, chunk):
        t1 = min(p_max, t0 + chunk)
        kc, vc = fetch(t0, t1)
        sc = torch.einsum("bsnmh,bnth->bnmst", qf, kc) * scale
        valid = torch.arange(t0, t1, device=dev)[None, :] < pos_t[:, None]  # [B, chunk]
        sc = sc.masked_fill(~valid[:, None, None, None, :], float("-inf"))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        finite = torch.isfinite(m_new)
        r = torch.where(finite, torch.exp(m - m_new), 0.0)
        p = torch.where(finite, torch.exp(sc - m_new), 0.0)
        l = l * r + p.sum(dim=-1, keepdim=True)
        acc = acc * r + torch.einsum("bnmst,bnth->bnmsh", p, vc)
        m = m_new
    return m, l, acc


def _merge_window(qf, m_c, l_c, acc_c, k_new, v_new, win_offset: int):
    """Combine the cache part with the causal attention inside the window:
    query row ``win_offset + i`` attends to window rows j ≤ that row.
    Returns the normalised output [B, KV, M, Sq, hd] in f32."""
    sq, hd = qf.shape[1], qf.shape[-1]
    s_w = k_new.shape[1]
    dev = qf.device
    sn = torch.einsum("bsnmh,bjnh->bnmsj", qf, k_new.float()) * (1.0 / (hd**0.5))
    causal = torch.arange(win_offset, win_offset + sq, device=dev)[:, None] >= torch.arange(s_w, device=dev)[None, :]
    sn = sn.masked_fill(~causal, float("-inf"))
    # The window always holds the self key, so the joint max is finite.
    m = torch.maximum(m_c, sn.amax(dim=-1, keepdim=True))
    r_c = torch.where(torch.isfinite(m_c), torch.exp(m_c - m), 0.0)
    en = torch.exp(sn - m)
    denom = l_c * r_c + en.sum(dim=-1, keepdim=True)
    out = acc_c * r_c + torch.einsum("bnmsj,bjnh->bnmsh", en, v_new.float())
    return out / denom


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """Causal GQA over a written cache, the reference's dense form: q ``[B, S,
    n_heads, hd]``, k/v ``[B, n_kv, T, hd]``, q_pos ``[B, S]``; key row t takes
    part for a query at position p iff t ≤ p.  f32 inside, q's dtype out."""
    b, s, n_heads, hd = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, n_kv, n_heads // n_kv, hd)
    scores = torch.einsum("bsnmh,bnth->bnmst", qf, k.float()) * (1.0 / hd**0.5)
    mask = torch.arange(t, device=q.device)[None, None, :] <= torch.as_tensor(q_pos, device=q.device)[:, :, None]
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    out = torch.einsum("bnmst,bnth->bsnmh", torch.softmax(scores, dim=-1), v.float())
    return out.reshape(b, s, n_heads, hd).to(q.dtype)
