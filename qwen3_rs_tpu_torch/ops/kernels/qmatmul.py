"""W8A16 grouped-dequant matmul: the Hopper kernel and its plain version.

``qmatmul_w8a16`` computes ``prologue(x) · dequant(W[layer]) (+ residual)``
for in-major weights: codes ``[N, D]`` or stacked ``[L, N, D]`` int8, scales
``[G, D]`` / ``[L, G, D]``.  It covers the reference package's three Pallas
entry points ``qmatmul_pallas`` (2-D weights), ``qmatmul_pallas_stacked``
(a layer of stacked weights) and ``qmatmul_pallas_stacked_fused`` (RMSNorm or
SwiGLU prologue, residual epilogue).

Numerics ("scale_w"): the prologue runs in f32, the activation is rounded to
bf16 after it, each weight element is ``bf16(bf16(code) · bf16(scale))`` and
the products accumulate in f32.

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/qmatmul_w8a16.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import QuantizedTensor
from . import LAUNCHES, build

# Activation rows the kernel takes in one call.  Longer prefill windows need
# the row-blocked kernel (ROADMAP.md queue 2, qmatmul_pallas_stacked_rows),
# which is not ported yet; the engine caps its windows at this size.
MAX_ROWS = 256
_BLOCK_COLS = 512  # output columns per block (32 lanes x 16 columns)
_SPLIT_ROWS = 64  # contraction rows per split are a multiple of this
_PROLOGUES = {None: 0, "rms": 1, "swiglu": 2}


def _layer_of(w: QuantizedTensor, layer):
    if w.q.dim() == 3:
        if layer is None:
            raise ValueError("stacked weights [L, N, D] need a layer index")
        return w.q[layer], w.scales[layer]
    if layer is not None:
        raise ValueError("a layer index needs stacked weights [L, N, D]")
    return w.q, w.scales


def qmatmul_w8a16_plain(
    x: torch.Tensor,
    w: QuantizedTensor,
    layer: int | None = None,
    *,
    norm_w: torch.Tensor | None = None,
    eps: float = 1e-6,
    residual: torch.Tensor | None = None,
    swiglu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arguments, same result up to
    the f32 summation order)."""
    codes, scales = _layer_of(w, layer)
    n, d = codes.shape
    g = n // scales.shape[0]
    xf = x.reshape(-1, x.shape[-1]).float()
    if swiglu:
        gate, up = xf[:, :n], xf[:, n:]
        xf = gate * torch.sigmoid(gate) * up
    if norm_w is not None:
        nw = norm_w if layer is None or norm_w.dim() == 1 else norm_w[layer]
        inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        xf = xf * inv * nw.float()
    xb = xf.to(torch.bfloat16).float()
    if residual is not None:
        out = residual.reshape(-1, d).float().clone()
    else:
        out = torch.zeros(xb.shape[0], d, dtype=torch.float32, device=x.device)
    sb = scales.to(torch.bfloat16)
    # Dequantize a band of rows at a time: the classifier's dense bf16 copy
    # would be 1.3 GB at 8B.
    budget = 1 << (26 if x.device.type == "cuda" else 22)
    rows = max(g, budget // d // g * g)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        wf = codes[r0:r1].to(torch.bfloat16) * sb[r0 // g : r1 // g].repeat_interleave(g, dim=0)
        out += xb[:, r0:r1] @ wf.float()
    return out.reshape(*x.shape[:-1], d)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("qmatmul_w8a16")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qmatmul_w8a16.argtypes = [p, i, p, p, p, p, i, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.qmatmul_w8a16.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(n: int, d: int, rows: int, bt: int, sms: int) -> tuple[int, int]:
    """(splits, rows per split) of the contraction axis: enough blocks for
    about three per SM, each split a multiple of 64 rows."""
    blocks = -(-d // _BLOCK_COLS) * -(-rows // bt)
    want = max(1, -(-3 * sms // blocks))
    kc = max(_SPLIT_ROWS, -(-n // want // _SPLIT_ROWS) * _SPLIT_ROWS)
    kc = min(kc, -(-n // 4) * 4)
    return -(-n // kc), kc


def _row_tile(rows: int) -> int:
    for bt in (1, 2, 4):
        if rows <= bt:
            return bt
    return 8


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"qmatmul_w8a16: {msg}")


def qmatmul_w8a16(
    x: torch.Tensor,
    w: QuantizedTensor,
    layer: int | None = None,
    *,
    norm_w: torch.Tensor | None = None,
    eps: float = 1e-6,
    residual: torch.Tensor | None = None,
    swiglu: bool = False,
) -> torch.Tensor:
    """``x [..., N]`` (``[..., 2N]`` gate|up with ``swiglu``) times layer
    ``layer`` of ``w`` → ``[..., D]`` f32.

    ``norm_w`` ([L, N] or [N] f32) fuses an RMSNorm prologue, ``swiglu`` a
    ``silu(gate)·up`` prologue, ``residual`` ([..., D]) is added once to the
    f32 result.
    """
    if norm_w is not None and swiglu:
        raise ValueError("qmatmul_w8a16: one prologue at a time (norm_w or swiglu)")
    if x.device.type == "cpu":
        return qmatmul_w8a16_plain(
            x, w, layer, norm_w=norm_w, eps=eps, residual=residual, swiglu=swiglu
        )
    _need(x.device.type == "cuda", f"tensors on {x.device} are neither CPU nor CUDA")
    codes, scales = w.q, w.scales
    stacked = codes.dim() == 3
    _need(codes.dim() in (2, 3) and scales.dim() == codes.dim(), "weights must be [N, D] or [L, N, D]")
    if stacked:
        _need(layer is not None and 0 <= layer < codes.shape[0], f"layer {layer} out of range")
    else:
        _need(layer is None, "a layer index needs stacked weights")
    n, d = codes.shape[-2:]
    groups = scales.shape[-2]
    _need(n % groups == 0 and scales.shape[-1] == d, f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    g = n // groups
    _need(g % 4 == 0, f"group size {g} must be a multiple of 4")
    _need(d % 16 == 0, f"D={d} must be a multiple of 16")
    _need(codes.dtype == torch.int8 and codes.is_contiguous(), "codes must be contiguous int8")
    _need(
        scales.dtype == torch.bfloat16 and scales.is_contiguous(),
        "scales must be contiguous bf16 (cast_weight_scales does that)",
    )
    _need(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype} is not f32/bf16")
    width = 2 * n if swiglu else n
    _need(x.shape[-1] == width, f"x width {x.shape[-1]} != {width}")
    x2 = x.reshape(-1, width).contiguous()
    rows = x2.shape[0]
    _need(
        0 < rows <= MAX_ROWS,
        f"{rows} activation rows; the kernel takes 1..{MAX_ROWS} "
        "(the >256-row kernel is not ported, ROADMAP.md queue 2)",
    )
    dev = x.device
    tensors = [codes, scales]
    nw_ptr = None
    if norm_w is not None:
        _need(norm_w.dtype == torch.float32 and norm_w.is_contiguous(), "norm_w must be contiguous f32")
        _need(norm_w.shape[-1] == n, f"norm_w {tuple(norm_w.shape)} does not fit N={n}")
        nw_ptr = norm_w.data_ptr()
        if norm_w.dim() == 2:
            _need(stacked and norm_w.shape[0] == codes.shape[0], "norm_w [L, N] needs stacked weights")
            nw_ptr += layer * n * 4
        tensors.append(norm_w)
    res = None
    if residual is not None:
        res = residual.reshape(-1, residual.shape[-1]).contiguous()
        _need(res.shape == (rows, d), f"residual {tuple(residual.shape)} != [{rows}, {d}]")
        _need(res.dtype in (torch.float32, torch.bfloat16), "residual must be f32/bf16")
        tensors.append(res)
    _need(all(t.device == dev for t in tensors), "all tensors must be on one device")
    _need(codes.data_ptr() % 16 == 0 and scales.data_ptr() % 16 == 0, "weights must be 16-byte aligned")

    li = layer if stacked else 0
    out = torch.empty(rows, d, dtype=torch.float32, device=dev)
    bt = _row_tile(rows)
    splits, kc = split_plan(n, d, rows, bt, _sm_count(dev.index or 0))
    partial = torch.empty(splits * rows * d, dtype=torch.float32, device=dev) if splits > 1 else None
    prologue = "rms" if norm_w is not None else ("swiglu" if swiglu else None)
    err = _lib().qmatmul_w8a16(
        x2.data_ptr(),
        int(x2.dtype == torch.bfloat16),
        codes.data_ptr() + li * n * d,
        scales.data_ptr() + li * groups * d * 2,
        nw_ptr,
        None if res is None else res.data_ptr(),
        int(res is not None and res.dtype == torch.bfloat16),
        out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        rows,
        n,
        d,
        g,
        _PROLOGUES[prologue],
        float(eps),
        bt,
        kc,
        splits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "qmatmul_w8a16")
    LAUNCHES["qmatmul_w8a16"] += 1
    return out.reshape(*x.shape[:-1], d)
