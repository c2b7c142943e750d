"""Group-wise quantized matmuls (fast mode, W8A16).

Weight convention, as in the reference package: **in-major** codes
``[N, D]`` int8 with scales ``[N / g, D]``; groups subdivide the contraction
axis N.  ``qmatmul`` takes f32/bf16 activations against those weights; for a
CUDA tensor it launches the hand-written kernel (``ops/kernels/qmatmul.py``)
and raises where the kernel cannot take the call, for a CPU tensor it runs
the kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

from .kernels.qmatmul import qmatmul_w8a16
from .quant import QuantizedTensor


def qmatmul(x: torch.Tensor, w: QuantizedTensor) -> torch.Tensor:
    """x ``[..., N]`` float × w (``[N, D]`` int8 in-major, ``[G, D]`` scales)
    → ``[..., D]`` f32."""
    return qmatmul_w8a16(x, w)


def dequant_weights(w: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize in-major codes to a dense ``[N, D]`` matrix (product in f32,
    rounded once to ``dtype``)."""
    n, d = w.q.shape
    g = n // w.scales.shape[0]
    wf = w.q.reshape(n // g, g, d).float() * w.scales[:, None, :].float()
    return wf.reshape(n, d).to(dtype)
