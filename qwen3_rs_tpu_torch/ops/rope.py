"""Rotary position embeddings, rotate-half convention (pair ``x[i]``,
``x[i + d/2]``, frequency ``theta^(-i/(d/2))``)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=8)
def rope_table(
    seq_len: int, head_dim: int, theta: float = 1e6, device: str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables ``[seq_len, head_dim // 2]`` in f32.  Computed on the
    host so every device sees the same table, then moved once."""
    half = head_dim // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32),
        -torch.arange(half, dtype=torch.float32) / half,
    )
    angles = torch.arange(seq_len, dtype=torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., head_dim]; cos/sin broadcastable to [..., head_dim // 2]."""
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
