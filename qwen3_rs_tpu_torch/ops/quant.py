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


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Row-major dequant: q * per-group scale along the last axis, in f32."""
    shape = qt.q.shape
    g = shape[-1] // qt.scales.shape[-1]
    out = qt.q.reshape(*shape[:-1], shape[-1] // g, g).float() * qt.scales[..., None].float()
    return out.reshape(shape).to(dtype)
