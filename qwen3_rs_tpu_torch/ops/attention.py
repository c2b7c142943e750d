"""Grouped-query attention over a cached prefix plus the current window.

Plain PyTorch; it serves the prefill windows (the reference package computes
those outside any Pallas kernel too).  Decode steps (S = 1) go through the
flash-decode kernel wrapper (``ops/kernels/flash_attention.py``).

Conventions, as in the reference package:
* queries  q:      [B, S, n_heads, head_dim]
* cache    k, v:   [B, n_kv_heads, T, head_dim] — rows t < pos_start[b] valid
* window   k/v:    [B, S, n_kv_heads, head_dim]
* scale 1/sqrt(head_dim); softmax in f32; query head h reads kv head
  ``h // (n_heads // n_kv_heads)``.
"""

from __future__ import annotations

import numpy as np
import torch


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
    """Causal GQA attention with one softmax over both parts.

    ``pos_start`` holds the host-side window offsets ([B] ints): only rows
    below ``max(pos_start)`` of the cache are read, and row t of request b
    takes part iff ``t < pos_start[b]``.  ``k/v_scale_cache`` ([B, kv, T])
    dequantize an INT8 cache as it is read.  Returns [B, S, n_heads, hd] in
    ``q.dtype``.
    """
    b, s, n_heads, hd = q.shape
    n_kv = k_cache.shape[1]
    kv_mul = n_heads // n_kv
    scale = 1.0 / (hd**0.5)
    pos_np = np.asarray(pos_start, np.int64).reshape(b)
    p_max = int(pos_np.max())
    dev = q.device

    qf = q.reshape(b, s, n_kv, kv_mul, hd).float()
    sn = torch.einsum("bsnmh,bjnh->bnmsj", qf, k_new.float()) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    sn = sn.masked_fill(~causal, float("-inf"))
    if p_max > 0:
        kc = k_cache[:, :, :p_max].float()
        vc = v_cache[:, :, :p_max].float()
        if k_scale_cache is not None:
            kc = kc * k_scale_cache[:, :, :p_max, None]
            vc = vc * v_scale_cache[:, :, :p_max, None]
        sc = torch.einsum("bsnmh,bnth->bnmst", qf, kc) * scale
        pos_t = torch.as_tensor(pos_np, device=dev)
        valid = torch.arange(p_max, device=dev)[None, :] < pos_t[:, None]  # [B, T]
        sc = sc.masked_fill(~valid[:, None, None, None, :], float("-inf"))
        scores = torch.cat([sc, sn], dim=-1)
    else:
        scores = sn
    # The window always holds the self key, so the max is finite.
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bnmsj,bjnh->bnmsh", e[..., p_max:], v_new.float())
    if p_max > 0:
        out = out + torch.einsum("bnmst,bnth->bnmsh", e[..., :p_max], vc)
    out = out / denom
    # [B, KV, M, S, hd] → [B, S, KV, M, hd] → [B, S, n_heads, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, n_heads, hd).to(q.dtype)
