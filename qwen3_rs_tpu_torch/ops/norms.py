"""RMS normalization: ``x / sqrt(mean(x²) + ε) * γ``, math in f32."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalize the last axis; the result keeps ``x``'s dtype."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (weight.float() * (xf * inv)).to(x.dtype)
