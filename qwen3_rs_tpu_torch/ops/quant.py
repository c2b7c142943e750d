"""Group-wise symmetric INT8 (Q8_0-style) tensors.

Linear layers use the in-major compute layout: codes ``[..., N, D]`` int8
with scales ``[..., N/g, D]`` (groups subdivide the contraction axis N).
The embedding keeps the row-major layout ``[V, dim]`` with scales
``[V, dim/g]`` (groups subdivide the last axis).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    """int8 codes + per-group scales (f32, or bf16 after the fast-mode cast)."""

    q: torch.Tensor
    scales: torch.Tensor

    @property
    def shape(self):
        return self.q.shape

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scales.to(device))


Q_MAX = 127.0


def quantize_activations(x: torch.Tensor, group_size: int) -> QuantizedTensor:
    """Per-group symmetric INT8 activations (exact mode): scale
    ``max|x| / 127`` over each group of the last axis (0 for an all-zero
    group, whose codes are 0), codes rounded half away from zero as
    ``trunc(x / scale ± 0.5)`` in f32, the Rust ``f32::round`` of the
    reference engine.  Returns codes ``[..., N]`` int8 and scales
    ``[..., N / group_size]`` f32."""
    shape = x.shape
    if shape[-1] % group_size:
        raise ValueError(f"width {shape[-1]} is not a multiple of the group size {group_size}")
    g = x.reshape(*shape[:-1], shape[-1] // group_size, group_size).float()
    scale = g.abs().amax(dim=-1) / Q_MAX
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    y = g / safe[..., None]
    q = torch.trunc(y + torch.where(y >= 0, 0.5, -0.5))
    q = torch.where(scale[..., None] == 0.0, torch.zeros_like(q), q).to(torch.int8)
    return QuantizedTensor(q.reshape(shape), scale)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Row-major dequant: q * per-group scale along the last axis, in f32."""
    shape = qt.q.shape
    g = shape[-1] // qt.scales.shape[-1]
    out = qt.q.reshape(*shape[:-1], shape[-1] // g, g).float() * qt.scales[..., None].float()
    return out.reshape(shape).to(dtype)
