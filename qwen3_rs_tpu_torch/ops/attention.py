"""Grouped-query attention over a cached prefix plus the current window.

Plain PyTorch; it serves the continuation prefill windows and every window
of the exact and f32 modes (the reference package computes those outside any
Pallas kernel too).  Fast-mode decode steps (S = 1) go through the
flash-decode kernel (``ops/kernels/flash_attention.py``), fresh fast-mode
windows of more than 256 rows through the causal prefill kernel
(``ops/kernels/prefill_attention.py``).

Conventions, as in the reference package:
* queries  q:      [B, S, n_heads, head_dim]
* cache    k, v:   [B, n_kv_heads, T, head_dim] — rows t < pos_start[b] valid
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
    b, s, n_heads, hd = q.shape
    n_kv = k_cache.shape[1]
    qf = q.reshape(b, s, n_kv, n_heads // n_kv, hd).float()
    pos_np = np.asarray(pos_start, np.int64).reshape(b)
    outs = []
    for c0 in range(0, s, QUERY_CHUNK):
        c1 = min(s, c0 + QUERY_CHUNK)
        m_c, l_c, acc_c = _cache_part(qf[:, c0:c1], k_cache, v_cache, pos_np, k_scale_cache, v_scale_cache)
        outs.append(_merge_window(qf[:, c0:c1], m_c, l_c, acc_c, k_new[:, :c1], v_new[:, :c1], c0))
    out = torch.cat(outs, dim=3)  # [B, KV, M, S, hd]
    # [B, KV, M, S, hd] → [B, S, KV, M, hd] → [B, S, n_heads, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, n_heads, hd).to(q.dtype)


def _cache_part(qf, k_cache, v_cache, pos_np, k_scale, v_scale):
    """Online softmax over the valid cache rows: (max, sum, acc) with shapes
    [B, KV, M, Sq, 1], [B, KV, M, Sq, 1], [B, KV, M, Sq, hd]; the max is -inf
    where a request has no cache row."""
    b, sq, n_kv, kv_mul, hd = qf.shape
    dev = qf.device
    scale = 1.0 / (hd**0.5)
    m = torch.full((b, n_kv, kv_mul, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((b, n_kv, kv_mul, sq, 1), device=dev)
    acc = torch.zeros((b, n_kv, kv_mul, sq, hd), device=dev)
    pos_t = torch.as_tensor(pos_np, device=dev)
    for t0 in range(0, int(pos_np.max()), CACHE_KEY_CHUNK):
        t1 = min(int(pos_np.max()), t0 + CACHE_KEY_CHUNK)
        kc = k_cache[:, :, t0:t1].float()
        vc = v_cache[:, :, t0:t1].float()
        if k_scale is not None:
            kc = kc * k_scale[:, :, t0:t1, None]
            vc = vc * v_scale[:, :, t0:t1, None]
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
