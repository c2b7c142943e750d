"""W8A8 row-blocked grouped matmul (exact mode): the Hopper kernel and its
plain version.

``qmatmul_w8a8_rows`` computes, for activations quantized per group
(``ops/quant.py::quantize_activations``: codes ``[rows, N]`` int8, scales
``[rows, G]`` f32) against layer ``layer`` of in-major weights (codes
``[L, N, D]``, scales ``[L, G, D]``):

    acc = 0;  for each group in order:  acc = acc + (f32(dot) · w_scale) · x_scale

where ``dot`` is the group's exact int8 · int8 → int32 product.  It replaces
the reference package's ``qmatmul_pallas_stacked_rows_a8``, which exact mode
reaches for windows of 128 rows or more (``ops/matmul.py::qmatmul_exact``).
Every multiply and add rounds on its own, in both versions, so they agree
bit for bit.  The kernel converts each group's integer sum to f32 without a
conversion instruction for g ≤ 128 (``magic_group_float``, its arithmetic).

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/qmatmul_a8.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..quant import QuantizedTensor
from . import LAUNCHES, build
from .qmatmul import _layer_of, _layer_on_card


def qmatmul_w8a8_rows_plain(
    xq: torch.Tensor, xs: torch.Tensor, w: QuantizedTensor, layer: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version: one f32 matmul per group (its integer sums stay
    below 2^24, so they are exact in any order), then the kernel's scale
    order and sequential f32 sum."""
    codes, scales = _layer_of(w, layer)
    n, d = codes.shape
    groups = scales.shape[0]
    g = n // groups
    xq2 = xq.reshape(-1, n)
    xs2 = xs.reshape(-1, groups).float()
    ws = scales.float()
    acc = torch.zeros(xq2.shape[0], d, dtype=torch.float32, device=xq.device)
    for gi in range(groups):
        sl = slice(gi * g, (gi + 1) * g)
        dot = xq2[:, sl].float() @ codes[sl].float()
        acc = acc + (dot * ws[gi]) * xs2[:, gi : gi + 1]
    return acc.reshape(*xq.shape[:-1], d)


MAGIC_BITS = 0x4B400000  # 1.5·2^23: a group's int32 partials start here in the kernel (g ≤ 128)
MAGIC_FLOAT = 12582912.0


def magic_group_float(dot: np.ndarray) -> np.ndarray:
    """The kernel's conversion of a group's int32 dot to f32 for g ≤ 128:
    the partials start at ``MAGIC_BITS``, the sum's bits read as a float are
    12582912 + dot for |dot| < 2^22, and one f32 subtraction leaves dot."""
    bits = (np.int64(MAGIC_BITS) + dot.astype(np.int64)).astype(np.uint32)
    return bits.view(np.float32) - np.float32(MAGIC_FLOAT)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("qmatmul_a8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul_w8a8_rows.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.qmatmul_w8a8_rows.restype = ctypes.c_int
    return lib


def qmatmul_w8a8_rows(
    xq: torch.Tensor, xs: torch.Tensor, w: QuantizedTensor, layer: int | None = None
) -> torch.Tensor:
    """``xq [..., N]`` int8 with ``xs [..., G]`` f32 times layer ``layer`` of
    ``w`` (or a 2-D weight) → ``[..., D]`` f32."""
    if xq.device.type == "cpu":
        return qmatmul_w8a8_rows_plain(xq, xs, w, layer)
    if xq.device.type != "cuda":
        raise ValueError(f"qmatmul_w8a8_rows: tensors on {xq.device} are neither CPU nor CUDA")
    codes, scales = _layer_on_card(w, layer, "qmatmul_w8a8_rows")
    n, d = codes.shape
    groups = scales.shape[0]
    g = n // groups

    def need(cond, msg):
        if not cond:
            raise ValueError(f"qmatmul_w8a8_rows: {msg}")

    need(n % 64 == 0 and g % 32 == 0, f"N={n} must be a multiple of 64 and the group size {g} of 32")
    need(d % 16 == 0, f"D={d} must be a multiple of 16")
    need(xq.dtype == torch.int8 and xq.shape[-1] == n, f"xq must be int8 [..., {n}]")
    xq2 = xq.reshape(-1, n).contiguous()
    if xq2.data_ptr() % 16:
        xq2 = xq2.clone()  # the kernel reads codes in 16-byte pieces
    xs2 = xs.reshape(-1, groups).float().contiguous()
    ws = scales.float().contiguous()
    rows = xq2.shape[0]
    need(xs2.shape[0] == rows, f"xs {tuple(xs.shape)} does not fit xq {tuple(xq.shape)}")
    need(xq2.device == xs2.device == codes.device == ws.device, "all tensors must be on one device")
    out = torch.empty(rows, d, dtype=torch.float32, device=xq.device)
    if rows:
        m_pad = -(-rows // 4) * 4  # the kernel reads a block's x scales in 16-byte pieces
        xs_t = torch.zeros(groups, m_pad, dtype=torch.float32, device=xq.device)
        xs_t[:, :rows] = xs2.t()
        err = _lib().qmatmul_w8a8_rows(
            xq2.data_ptr(), xs_t.data_ptr(), codes.data_ptr(), ws.data_ptr(), out.data_ptr(),
            rows, m_pad, n, d, g, torch.cuda.current_stream(xq.device).cuda_stream,
        )
        build.check(err, "qmatmul_w8a8_rows")
        LAUNCHES["qmatmul_w8a8_rows"] += 1
    return out.reshape(*xq.shape[:-1], d)
