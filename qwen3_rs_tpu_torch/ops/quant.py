"""Group-wise symmetric INT8 (Q8_0-style) and INT4 (Q4_0-style) tensors.

Linear layers use the in-major compute layout: codes ``[..., N, D]`` int8
with scales ``[..., N/g, D]`` (groups subdivide the contraction axis N).
The embedding keeps the row-major layout ``[V, dim]`` with scales
``[V, dim/g]`` (groups subdivide the last axis).

INT4 linear layers (``Q4Tensor``) pack two codes per byte, **group
split-half along N**: byte row ``k·g/2 + j`` of group ``k`` holds in-row
``k·g + j`` in its low nibble and in-row ``k·g + g/2 + j`` in its high
nibble, each stored as ``code + Q4_BIAS`` ("biased-v2"), so both nibbles
unpack unsigned.  The exporter's quantizers (``quantize_weights_np``,
``quantize_weights_q4_np``) round half to even and work on row-major
``[..., N]`` arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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
Q4_MAX = 7.0
Q4_BIAS = 8  # stored nibble = code + 8


class Q4Tensor(NamedTuple):
    """Nibble-packed INT4 codes ``[..., N/2, D]`` uint8 + per-group scales
    ``[..., N/g, D]`` (in-major only).  ``shape`` is the logical
    ``[..., N, D]``."""

    q: torch.Tensor
    scales: torch.Tensor

    @property
    def group_size(self) -> int:
        return 2 * self.q.shape[-2] // self.scales.shape[-2]

    @property
    def shape(self):
        return (*self.q.shape[:-2], 2 * self.q.shape[-2], self.q.shape[-1])

    def to(self, device) -> "Q4Tensor":
        return Q4Tensor(self.q.to(device), self.scales.to(device))


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


def quantize_weights(w: torch.Tensor, group_size: int) -> QuantizedTensor:
    """Q8_0 weight quantization on the tensor's device, over groups of the
    last axis (the math of ``quantize_weights_np``): scale ``max|w| / 127``
    (1 for an all-zero group), codes rounded half to even and clipped."""
    shape = w.shape
    if shape[-1] % group_size:
        raise ValueError(f"width {shape[-1]} is not a multiple of the group size {group_size}")
    g = w.float().reshape(*shape[:-1], shape[-1] // group_size, group_size)
    amax = g.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale[..., None]), -127, 127).to(torch.int8)
    return QuantizedTensor(q.reshape(shape), scale)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Row-major dequant: q * per-group scale along the last axis, in f32."""
    shape = qt.q.shape
    g = shape[-1] // qt.scales.shape[-1]
    out = qt.q.reshape(*shape[:-1], shape[-1] // g, g).float() * qt.scales[..., None].float()
    return out.reshape(shape).to(dtype)


# ------------------------------------------------------------ export (numpy)
def _quantize_groups_np(w: np.ndarray, group_size: int, q_max: float):
    """Symmetric per-group quantization over the last axis: scale
    ``max|w| / q_max`` (1.0 for an all-zero group), codes rounded half to
    even and clamped to ±q_max.  Returns (int8 codes, f32 scales, max
    reconstruction error)."""
    shape = w.shape
    if w.size % group_size != 0:
        raise ValueError("Weight length is not a multiple of group_size")
    g = np.ascontiguousarray(w, dtype=np.float32).reshape(-1, group_size)
    amax = np.max(np.abs(g), axis=-1)
    scale = np.where(amax > 0.0, amax / q_max, 1.0).astype(np.float32)
    q = np.clip(np.round(g / scale[:, None]), -q_max, q_max).astype(np.int8)
    recon = q.astype(np.float32) * scale[:, None]
    max_error = float(np.max(np.abs(recon - g))) if g.size else 0.0
    return q.reshape(shape), scale.reshape(*shape[:-1], shape[-1] // group_size), max_error


def quantize_weights_np(w: np.ndarray, group_size: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Q8_0 weight quantization (the exporter's): codes in [-127, 127]."""
    return _quantize_groups_np(w, group_size, Q_MAX)


def quantize_weights_q4_np(w: np.ndarray, group_size: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Q4_0 weight quantization: unpacked int8 codes in [-7, 7]; packing
    (``pack_q4_np``) happens in the in-major layout."""
    return _quantize_groups_np(w, group_size, Q4_MAX)


def pack_q4_np(q: np.ndarray, group_size: int) -> np.ndarray:
    """int8 codes ``[..., N, D]`` in [-8, 7] → packed uint8 ``[..., N/2, D]``."""
    n = q.shape[-2]
    if n % group_size or group_size % 2:
        raise ValueError(f"codes {q.shape} do not pack in groups of {group_size}")
    h = group_size // 2
    g = q.reshape(*q.shape[:-2], n // group_size, group_size, q.shape[-1])
    lo = (g[..., :h, :] + Q4_BIAS).astype(np.uint8) & 0xF
    hi = ((g[..., h:, :] + Q4_BIAS).astype(np.uint8) & 0xF) << 4
    return (lo | hi).reshape(*q.shape[:-2], n // 2, q.shape[-1])


def unpack_q4_np(packed: np.ndarray, group_size: int) -> np.ndarray:
    """Packed uint8 ``[..., N/2, D]`` → int8 codes ``[..., N, D]``."""
    h = group_size // 2
    n2 = packed.shape[-2]
    g = packed.reshape(*packed.shape[:-2], n2 // h, h, packed.shape[-1])
    lo = (g & 0xF).astype(np.int8) - Q4_BIAS
    hi = (g >> 4).astype(np.int8) - Q4_BIAS
    return np.concatenate([lo, hi], axis=-2).reshape(*packed.shape[:-2], 2 * n2, packed.shape[-1])


# ------------------------------------------------------------- INT4 (torch)
def unpack_q4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Packed uint8 ``[..., N/2, D]`` → int8 codes ``[..., N, D]``."""
    h = group_size // 2
    n2 = packed.shape[-2]
    g = packed.reshape(*packed.shape[:-2], n2 // h, h, packed.shape[-1])
    lo = (g & 0xF).to(torch.int8) - Q4_BIAS
    hi = (g >> 4).to(torch.int8) - Q4_BIAS
    return torch.cat([lo, hi], dim=-2).reshape(*packed.shape[:-2], 2 * n2, packed.shape[-1])


def dequantize_q4_inmajor(qt: Q4Tensor, dtype=torch.float32) -> torch.Tensor:
    """Unpack and dequantize an in-major ``Q4Tensor`` → ``[..., N, D]``: the
    product of the f32 code and the f32 scale, cast once to ``dtype``."""
    g = qt.group_size
    codes = unpack_q4(qt.q, g).float()
    n, d = codes.shape[-2:]
    grp = codes.reshape(*codes.shape[:-2], n // g, g, d)
    out = grp * qt.scales[..., :, None, :].float()
    return out.reshape(*codes.shape[:-2], n, d).to(dtype)


def dequantize_np(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Row-major codes ``[..., N]`` times their group scales ``[..., N/g]``, f32."""
    group_size = q.shape[-1] // scales.shape[-1]
    g = q.astype(np.float32).reshape(*q.shape[:-1], scales.shape[-1], group_size)
    return (g * scales[..., None].astype(np.float32)).reshape(q.shape)
