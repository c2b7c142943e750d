"""Group-wise quantized matmuls: fast (W8A16), exact (W8A8) and f32.

Weight convention, as in the reference package: **in-major** codes
``[N, D]`` (or stacked ``[L, N, D]``) int8 with scales ``[N / g, D]``; groups
subdivide the contraction axis N.

* ``qmatmul`` takes f32/bf16 activations (the classifier's path): up to 256
  rows the hand-written W8A16 kernel, above that the reference package's
  dense forms (a dequantized bf16 matrix with an f32 product from 512 rows,
  the per-group form in between).
* ``qmatmul_exact`` takes quantized activations (exact mode): the W8A8 rows
  kernel from 128 rows, below that the reference's group-by-group scan.
* ``dequant_weights`` and ``f32_matmul`` serve the f32 mode; ``f32_matmul``
  takes INT4 (``Q4Tensor``) weights too.  INT4 has no exact mode:
  ``qmatmul_exact`` refuses it, as the reference package does.

For a CUDA tensor a kernel wrapper launches its kernel or raises; for a CPU
tensor it runs the kernel's plain PyTorch version.
"""

from __future__ import annotations

import contextlib

import torch

from .kernels.qmatmul import MAX_ROWS, _layer_of, qmatmul_w8a16
from .kernels.qmatmul_a8 import qmatmul_w8a8_rows
from .quant import Q4Tensor, QuantizedTensor, dequantize_q4_inmajor

DENSE_MIN_ROWS = 512  # from here ``qmatmul`` dequantizes and runs one dense product
EXACT_KERNEL_MIN_ROWS = 128  # from here ``qmatmul_exact`` runs the W8A8 kernel
_DENSE_COLS = 16384  # output columns per step of the dense forms (bounds their temporaries)
_GROUP_COLS = 2048  # output columns per step of the per-group form
_SCAN_ELEMS = 1 << 26  # [G, rows, cols] group terms per step of the exact scan


@contextlib.contextmanager
def exact_float_products():
    """Full-precision products for the dense matmuls of this module: no TF32
    for f32 inputs, and no reduced-precision reduction inside a bf16 product
    (its f32 sum is rounded once, as ``preferred_element_type=f32`` and a
    cast would round it).  Every flag reads as before afterwards, torch's
    ``fp32_precision`` too, which setting ``allow_tf32`` changes."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32, m.allow_bf16_reduced_precision_reduction
    precision = getattr(m, "fp32_precision", None)
    m.allow_tf32, m.allow_bf16_reduced_precision_reduction = False, False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = prev
        if precision is not None:
            m.fp32_precision = precision


def transpose_quantized(w: QuantizedTensor) -> QuantizedTensor:
    """Row-major storage (``[D, N]`` codes, ``[D, G]`` scales: the checkpoint
    and reference layout) → in-major compute layout (``[N, D]``, ``[G, D]``),
    as views."""
    return QuantizedTensor(w.q.T, w.scales.T)


def dequant_weights(w: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize in-major codes ``[N, D]`` to a dense matrix: the product in
    f32, rounded once to ``dtype``."""
    n, d = w.q.shape
    g = n // w.scales.shape[0]
    wf = w.q.reshape(n // g, g, d).float() * w.scales[:, None, :].float()
    return wf.reshape(n, d).to(dtype)


def f32_matmul(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None) -> torch.Tensor:
    """f32 mode: ``x`` in f32 times the weights dequantized to f32, in full
    f32 precision → ``[..., D]`` f32."""
    codes, scales = _layer_of(w, layer)
    if isinstance(w, Q4Tensor):
        wf = dequantize_q4_inmajor(Q4Tensor(codes, scales), torch.float32)
    else:
        wf = dequant_weights(QuantizedTensor(codes, scales), torch.float32)
    with exact_float_products():
        return x.float() @ wf


def qmatmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x ``[..., N]`` float × w (``[N, D]`` int8 in-major, ``[G, D]`` scales)
    → ``[..., D]`` f32."""
    n, d = w.q.shape
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    if rows <= MAX_ROWS:
        return qmatmul_w8a16(x, w)
    out = torch.empty(rows, d, dtype=torch.float32, device=x.device)
    if rows >= DENSE_MIN_ROWS:
        # Long windows (all-logits evaluation): the weights dequantized to bf16
        # (f32 scales unrounded), then one product whose f32 sums stay f32.
        xb = x2.to(torch.bfloat16).float()
        with exact_float_products():
            for c0 in range(0, d, _DENSE_COLS):
                c1 = min(d, c0 + _DENSE_COLS)
                wc = dequant_weights(QuantizedTensor(w.q[:, c0:c1], w.scales[:, c0:c1]))
                out[:, c0:c1] = xb @ wc.float()
    else:
        # The per-group form: Σ_G (x_G · codes_G) · scale_G, all in f32.
        groups = w.scales.shape[0]
        xg = x2.float().reshape(rows, groups, n // groups)
        with exact_float_products():
            for c0 in range(0, d, _GROUP_COLS):
                c1 = min(d, c0 + _GROUP_COLS)
                wq = w.q[:, c0:c1].float().reshape(groups, n // groups, c1 - c0)
                dots = torch.einsum("bgk,gkd->gbd", xg, wq)
                out[:, c0:c1] = torch.einsum("gbd,gd->bd", dots, w.scales[:, c0:c1].float())
    return out.reshape(*x.shape[:-1], d)


def qmatmul_exact(x: QuantizedTensor, w: QuantizedTensor, layer: int | None = None) -> torch.Tensor:
    """Reference-exact W8A8 grouped matmul: ``x.q [..., N]`` int8 with
    ``x.scales [..., G]`` times layer ``layer`` of ``w`` → ``[..., D]`` f32.

    From ``EXACT_KERNEL_MIN_ROWS`` rows the W8A8 kernel, which sums
    ``(dot · w_scale) · x_scale``; below, the reference's scan, which sums
    ``(dot · x_scale) · w_scale``.  The two orders round differently, and the
    reference package routes the same way.
    """
    if isinstance(w, Q4Tensor):
        raise ValueError("INT4 weights have no reference-exact (W8A8) mode")
    n = x.q.shape[-1]
    rows = x.q.numel() // n
    if rows >= EXACT_KERNEL_MIN_ROWS:
        return qmatmul_w8a8_rows(x.q, x.scales, w, layer)
    codes, scales = _layer_of(w, layer)
    d = codes.shape[1]
    groups = scales.shape[0]
    xq = x.q.reshape(rows, groups, n // groups).float()
    xs = x.scales.reshape(rows, groups).float().T[:, :, None]  # [G, rows, 1]
    acc = torch.zeros(rows, d, dtype=torch.float32, device=x.q.device)
    cols = max(1, _SCAN_ELEMS // (groups * rows))
    for c0 in range(0, d, cols):
        c1 = min(d, c0 + cols)
        with exact_float_products():
            # Integer group dots below 2^24: exact in f32 whatever the order.
            dots = torch.einsum(
                "bgk,gkd->gbd", xq, codes[:, c0:c1].float().reshape(groups, n // groups, c1 - c0)
            )
        terms = (dots * xs) * scales[:, None, c0:c1].float()  # [G, rows, cols]
        part = acc[:, c0:c1]
        for gi in range(groups):  # the f32 sum in group order, one rounding per add
            part.add_(terms[gi])
    return acc.reshape(*x.q.shape[:-1], d)
