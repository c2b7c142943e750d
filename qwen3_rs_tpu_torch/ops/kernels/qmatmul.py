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

The wrapper routes by rows alone (``route``): one row (decode at b = 1)
takes the row kernel (``qmatmul_w8a16_row``), one launch that applies the
prologue itself, keeps its codes several k-slices deep in flight and lets
``mma.sync`` take the products of the row zero-padded to n8 (``row_plan``
picks its contraction split, the strip's last block sums the splits);
from ``MMA_MIN_ROWS`` up to ``TC_MIN_ROWS`` rows the mma kernel
(``qmatmul_w8a16_mma``), which dequantizes each weight once into
``mma.sync``'s A operand and lets the tensor cores take the rows
(``mma_plan`` picks its contraction split; ``mma_k_slots``, ``mma_cols`` and
``mma_slot_rows`` are its fragment maps, the row kernel's too); a larger
window the tensor-core kernel (``qmatmul_w8a16_tc``), which stages the
prologue's bf16 activation once and streams each weight byte once for all
the rows on ``wgmma`` (``tc_plan`` picks its row tile and contraction
split).  Each kernel counts its launches under its own ``LAUNCHES`` key (the row
kernel under ``qmatmul_w8a16``).

For windows of more than ``MAX_ROWS`` rows, ``qmatmul_w8a16_rows`` (the
reference package's ``qmatmul_pallas_stacked_rows``) takes the projection on
the tensor cores, without prologue or epilogue; and ``dequant_w8_stacked``
(``dequant_pallas_stacked``) turns one layer's codes into a dense bf16
matrix for the long-prefill "xdot" path.

The two matmul wrappers take ``Q4Tensor`` weights too (nibble-packed INT4,
``ops/quant.py``), with the same numerics on the codes -8..7: the Q4 variant
of each kernel, counted under its own ``LAUNCHES`` key (``*_q4``).
``dequant_q4_stacked`` is the Q4 dequant, whose numerics differ from the
INT8 one: scales rounded to bf16, then a bf16 product, as the reference
kernel's "int" unpack.

For a CPU tensor each wrapper runs its plain PyTorch version; for a CUDA
tensor it launches ``csrc/qmatmul_w8a16.cu``, ``csrc/qmatmul_rows.cu`` or
``csrc/dequant.cu``, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import Q4Tensor, QuantizedTensor, unpack_q4
from . import LAUNCHES, build

# Activation rows the fused kernel takes in one call; longer windows take the
# row-blocked kernel (``qmatmul_w8a16_rows``).
MAX_ROWS = 256
_PROLOGUES = {None: 0, "rms": 1, "swiglu": 2}
# The crossovers of the three routes: windows of at least MMA_MIN_ROWS rows
# take the mma kernel, of at least TC_MIN_ROWS rows the tensor-core kernel.
# Set from chip_smoke.py's timings of the routes at 1-4, 8 and 16 rows over
# the four 8B projections (PERF.md): the row kernel is fastest at 1 row, the
# mma kernel from 2 to 8 (one n8 tile), the tensor cores from 9 (the mma
# kernel's second n8 tile).
MMA_MIN_ROWS = 2
TC_MIN_ROWS = 9
_ROW_SLICE = 16  # contraction slots of the row kernel's k-slice
_ROW_BLOCK_COLS = 128  # output columns of its block
_ROW_WARPS = 8  # warps of its block, each a run of the block's k-slices
_ROW_MAX_SPLIT = 1024  # its k-slices of a block at most
_ROW_SMEM_CAP = 64 * 1024  # its shared memory a block at most: three blocks fit an SM
_ROW_SCALE_ROW = 2 * _ROW_BLOCK_COLS  # bytes of one group's scales over a block's columns
_ROW_WAVE_SHARE = 0.95  # the share of a wave of resident blocks the row plan fills
MMA_MAX_ROWS = 16  # the mma kernel takes 1..16 rows (one or two n8 tiles)
_MMA_SLICE = 16  # contraction slots of an mma k-slice
_MMA_BLOCK_COLS = 128  # output columns of a block (eight m16 tiles)
_MMA_WARPS = 8  # warps of a block, each a run of its k-slices
_MMA_MAX_SPLIT = 128  # k-slices of a block at most (2048 contraction rows)
TC_ROW_TILES = (64, 128, 256)  # the tensor-core kernel's row tiles (wgmma N)
_TC_SLOTS = 64  # contraction rows (INT4: 32 packed rows) per k-tile


# ------------------------------------------------------------------- gates
# The reference package's tiling gates for its W8A16 kernels (``qmatmul.py``
# ``supports_shapes``, ``rows_supported``, ``dequant_supported``), copied with
# their default budgets and no environment reads.  The forward asks them
# before a launch and sends a shape they refuse to the plain projection; the
# port's kernels take every shape they admit.
_ROW_BLOCKS = (512, 256, 128)  # the row-blocked kernel's row tiles
_ROWS_VMEM_CAP = 23 * 1024 * 1024  # its tile budget, in its estimate's units


def _divisor_tiles(dim: int, step: int, cap: int) -> list[int]:
    return [c for c in range(step, min(dim, cap) + 1, step) if dim % c == 0]


def _tile_candidates(n: int, d: int, g: int) -> tuple[list[int], list[int]]:
    """The reference's (tile_n, tile_d) candidates: tile_n a multiple of g
    with 8-aligned group rows (or all of n), tile_d a multiple of 256 (else
    of 128)."""
    def n_ok(c: int) -> bool:
        return c % g == 0 and ((c // g) % 8 == 0 or c == n)

    n_cands = [c for c in _divisor_tiles(n, max(g, 256), 8192) if n_ok(c)]
    n_cands = n_cands or [c for c in _divisor_tiles(n, 128, 8192) if n_ok(c)]
    return n_cands, _divisor_tiles(d, 256, 8192) or _divisor_tiles(d, 128, 8192)


def supports_shapes(n: int, d: int, group_size: int, q4: bool = False) -> bool:
    """The reference's gate for its decode-sized W8A16 kernels (≤ 256 rows)."""
    if q4 and group_size % 2:
        return False
    n_cands, d_cands = _tile_candidates(n, d, group_size)
    return bool(n_cands and d_cands)


def rows_supported(n: int, d: int, group_size: int, b: int, q4: bool = False) -> bool:
    """The reference's gate for its row-blocked kernel at ``b`` rows (the
    rows it runs: its engine pads a window to a power-of-two bucket)."""
    if q4 and group_size % 2:
        return False
    tile_b = next((c for c in _ROW_BLOCKS if b % c == 0), None)
    if tile_b is None:
        return False
    n_cands, d_cands = _tile_candidates(n, d, group_size)
    per_elem = 12 if q4 else 8
    return any(per_elem * tn * td + 8 * tile_b * (tn + td) <= _ROWS_VMEM_CAP for tn in n_cands for td in d_cands)


def dequant_supported(n: int, d: int, group_size: int, q4: bool = False) -> bool:
    """The reference's gate for its dequant kernel."""
    tile_n = next((t for t in (512, 256, 128, 64) if n % t == 0 and t % group_size == 0), None)
    tile_d = next((t for t in (1024, 512, 256, 128) if d % t == 0), None)
    return tile_n is not None and tile_d is not None and (not q4 or group_size % 2 == 0)


def _codes_band(w, codes: torch.Tensor, r0: int, r1: int, g: int) -> torch.Tensor:
    """In-rows ``r0:r1`` (whole groups) of one layer's codes as int8 ``[r1-r0, D]``;
    packed INT4 rows are unpacked."""
    if isinstance(w, Q4Tensor):
        return unpack_q4(codes[r0 // 2 : r1 // 2], g)
    return codes[r0:r1]


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
    the f32 summation order); ``w`` a ``QuantizedTensor`` or a ``Q4Tensor``."""
    codes, scales = _layer_of(w, layer)
    n, d = w.shape[-2:]
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
        wf = _codes_band(w, codes, r0, r1, g).to(torch.bfloat16) * sb[r0 // g : r1 // g].repeat_interleave(g, dim=0)
        out += xb[:, r0:r1] @ wf.float()
    return out.reshape(*x.shape[:-1], d)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("qmatmul_w8a16")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qmatmul_w8a16_tc.argtypes = [p, i, p, p, p, p, p, i, p, p, i, i, i, i, i, f, i, i, i, i, p]
    lib.qmatmul_w8a16_tc.restype = ctypes.c_int
    lib.qmatmul_w8a16_mma.argtypes = [p, i, p, p, p, p, p, i, p, p, p, i, i, i, i, i, f, i, i, i, p]
    lib.qmatmul_w8a16_mma.restype = ctypes.c_int
    lib.qmatmul_w8a16_row.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, f, i, i, i, p]
    lib.qmatmul_w8a16_row.restype = ctypes.c_int
    lib.qmatmul_w8a16_row_blocks_per_sm.argtypes = [i, i]
    lib.qmatmul_w8a16_row_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def _row_blocks_per_sm(index: int, q4: bool, uniform: bool) -> int:
    """Row-kernel blocks one SM of card ``index`` holds at once (registers
    alone: a block's shared memory stays within ``_ROW_SMEM_CAP``, so three
    fit), at most 3."""
    with torch.cuda.device(index):
        n = _lib().qmatmul_w8a16_row_blocks_per_sm(int(q4), int(uniform))
    if n < 1:
        raise RuntimeError("qmatmul_w8a16_row: the occupancy query failed")
    return min(n, 3)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def route(rows: int) -> str:
    """The kernel that takes a window of ``rows`` rows: ``"row"`` below
    ``MMA_MIN_ROWS`` (one row), ``"mma"`` below ``TC_MIN_ROWS``, ``"tc"``
    from it on."""
    if not 0 < rows <= MAX_ROWS:
        raise ValueError(f"qmatmul_w8a16: {rows} activation rows; the kernels take 1..{MAX_ROWS}")
    return "tc" if rows >= TC_MIN_ROWS else "mma" if rows >= MMA_MIN_ROWS else "row"


def row_smem_bytes(spb: int, g: int) -> int:
    """Shared memory of a row-kernel block of ``spb`` k-slices at group size
    ``g``: the scale rows of the groups its slots touch (at most
    ``spb·16/g + 2``), then its staged bf16 slots."""
    return -(-(spb * _ROW_SLICE // g + 2) * _ROW_SCALE_ROW // 16) * 16 + spb * _ROW_SLICE * 2


def row_max_spb(g: int) -> int:
    """The row kernel's longest split at group size ``g``: whole slices for
    each of the 8 warps, at most ``_ROW_MAX_SPLIT``, and a block's shared
    memory within ``_ROW_SMEM_CAP``."""
    spb = _ROW_MAX_SPLIT
    while spb > _ROW_WARPS and row_smem_bytes(spb, g) > _ROW_SMEM_CAP:
        spb -= _ROW_WARPS
    return spb


@functools.cache
def row_plan(n: int, d: int, g: int, q4: bool, sms: int, per_sm: int) -> tuple[int, int]:
    """(splits, k-slices per split) of the row kernel for an ``[N, D]``
    weight on ``sms`` SMs holding ``per_sm`` of its blocks each.

    A block is 128 output columns by a split's 16-slot k-slices (a multiple
    of 8: an equal run for each warp).  A block's own stream is bound by
    the bytes it keeps in flight, so the card needs about a full wave of
    resident blocks (``per_sm·sms``) to reach its rate, and each block pays
    a fixed start (its scale rows, the prologue's loads) and end (its sums):
    the plan takes the fewest splits whose blocks fill ``_ROW_WAVE_SHARE``
    of a wave, within the split cap (else the most splits there are); where
    those blocks would spill into a second wave that stays under half full,
    it takes the most splits that fit one wave instead.  (On an H100 fewer
    blocks streamed slower and more splits paid their fixed work again.)"""
    slices = -(-n // _ROW_SLICE)
    strips = -(-d // _ROW_BLOCK_COLS)
    cap = row_max_spb(g)
    plans = []  # (splits, spb) by increasing splits, each split count once
    for want in range(1, slices + 1):
        spb = -(-(-(-slices // want)) // _ROW_WARPS) * _ROW_WARPS
        if -(-slices // spb) == want and spb <= cap:
            plans.append((want, spb))
    wave = per_sm * sms
    fill = [p for p in plans if strips * p[0] >= _ROW_WAVE_SHARE * wave]
    if not fill:
        return plans[-1]
    one_wave = [p for p in plans if strips * p[0] <= wave]
    if wave < strips * fill[0][0] < 1.5 * wave and one_wave:
        return one_wave[-1]
    return fill[0]


def row_runs(n: int, splits: int, spb: int, q4: bool) -> list[list[tuple[int, int]]]:
    """The code rows that each warp of a row-kernel block streams, as the
    kernel cuts them: per split (in split order), per warp (in warp order),
    ``[first, end)`` code rows (INT4: packed rows), a contiguous run of the
    split's k-slices; rows past the weight are zeros the kernel never reads."""
    slices = -(-n // _ROW_SLICE)
    per_slice = _ROW_SLICE // 2 if q4 else _ROW_SLICE
    code_rows = n // 2 if q4 else n
    out = []
    for split in range(splits):
        s0 = split * spb
        ns = min(slices - s0, spb)
        per = -(-ns // _ROW_WARPS)
        runs = []
        for warp in range(_ROW_WARPS):
            first, last = s0 + min(ns, warp * per), s0 + min(ns, (warp + 1) * per)
            runs.append((min(first * per_slice, code_rows), min(last * per_slice, code_rows)))
        out.append(runs)
    return out


def mma_k_slots() -> torch.Tensor:
    """The mma kernel's contraction relabelling within a 16-slot k-slice:
    entry k is the slot that ``mma.sync``'s k index k holds.  Thread t of a
    quad holds k = 2t, 2t+1, 2t+8, 2t+9, which are slots 4t .. 4t+3: the four
    code rows it loads and the four activation slots of its B fragment."""
    k = torch.arange(_MMA_SLICE)
    return 4 * ((k % 8) // 2) + 2 * (k // 8) + k % 2


def mma_cols() -> torch.Tensor:
    """The mma kernel's column relabelling within a warp's 128 columns:
    entry ``[mt, r]`` is the column that fragment row r of m16 tile mt
    holds.  Lane group r8 (rows r8 and r8+8 of every tile) holds columns
    16·r8 .. 16·r8+15, one 16-byte load of a code row."""
    mt = torch.arange(8)[:, None]
    r = torch.arange(16)[None, :]
    return 16 * (r % 8) + 2 * mt + r // 8


def mma_slot_rows(n: int, g: int, q4: bool) -> torch.Tensor:
    """The activation in-row of each of the ``n`` contraction slots, in the
    order the mma kernel stages them: INT8 slot s is in-row s; INT4 slot
    2p+h is packed row p's low (h = 0) or high (h = 1) nibble, in-row
    ``(p // (g/2))·g + p % (g/2) + h·g/2``."""
    s = torch.arange(n)
    if not q4:
        return s
    p, half = s // 2, g // 2
    return (p // half) * g + p % half + (s % 2) * half


@functools.cache
def mma_plan(n: int, d: int, rows: int, sms: int) -> tuple[int, int]:
    """(splits, k-slices per split) of the mma kernel for ``rows`` rows of
    an ``[N, D]`` weight on ``sms`` SMs.

    A block is 128 output columns by a split's 16-slot k-slices, shared by
    its 8 warps (a multiple of 8, so each warp streams an equal run; at
    most 128), two blocks resident an SM.  An SM's time is its blocks'
    bytes: the plan takes the least
    ``ceil(blocks / sms)`` times a block's codes (2 KB a slice, and 4
    slices of start-up), plus an SM's share of the f32 partials that a
    split writes and the strip's last block reads."""
    if not 0 < rows <= MMA_MAX_ROWS:
        raise ValueError(f"qmatmul_w8a16_mma: {rows} activation rows; the kernel takes 1..{MMA_MAX_ROWS}")
    slices = -(-n // _MMA_SLICE)
    strips = -(-d // _MMA_BLOCK_COLS)
    best = None
    for want in range(1, -(-slices // _MMA_WARPS) + 1):
        spb = -(-(-(-slices // want)) // _MMA_WARPS) * _MMA_WARPS
        splits = -(-slices // spb)
        if splits != want or spb > _MMA_MAX_SPLIT:
            continue  # the same plan as a smaller split count, or too long a split
        cost = -(-strips * splits // sms) * (spb + 4) * 2048
        if splits > 1:
            cost += splits * rows * d * 8 / sms
        if best is None or cost < best[0]:
            best = (cost, splits, spb)
    return best[1], best[2]


@functools.cache
def tc_plan(n: int, d: int, rows: int, sms: int) -> tuple[int, int, int]:
    """(row tile, splits, k-tiles per split) of the tensor-core kernel for
    ``rows`` rows of an ``[N, D]`` weight on ``sms`` SMs.

    The row tile is the smallest of ``TC_ROW_TILES`` that holds the rows; a
    tile covers 256 output columns (128 at the 256-row tile).  The
    contraction's k-tiles of 64 rows are split so that the tiles fill the
    card: the plan takes the least ``waves * kts`` (a block's k-tiles, one
    block per SM) plus the f32 partials' write and read where it splits,
    in k-tiles of codes (``rows / 8`` per tile), spread over the SMs.
    """
    tile = next(t for t in TC_ROW_TILES if rows <= t)
    strips = -(-d // (256 if tile <= 128 else 128))
    k_tiles = -(-n // _TC_SLOTS)
    best = None
    for want in range(1, k_tiles + 1):
        kts = -(-k_tiles // want)
        splits = -(-k_tiles // kts)
        if splits != want:
            continue  # the same plan as a smaller split count
        cost = -(-strips * splits // sms) * kts + (splits > 1) * splits * strips * rows / (8 * sms)
        if best is None or cost < best[0]:
            best = (cost, splits, kts)
    return tile, best[1], best[2]


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
    ``layer`` of ``w`` (a ``QuantizedTensor`` or a ``Q4Tensor``) → ``[..., D]``
    f32.

    ``norm_w`` ([L, N] or [N] f32) fuses an RMSNorm prologue, ``swiglu`` a
    ``silu(gate)·up`` prologue, ``residual`` ([..., D]) is added once to the
    f32 result.  On the card the rows alone pick the kernel (``route``).
    """
    if norm_w is not None and swiglu:
        raise ValueError("qmatmul_w8a16: one prologue at a time (norm_w or swiglu)")
    kw = {"norm_w": norm_w, "eps": eps, "residual": residual, "swiglu": swiglu}
    if x.device.type == "cpu":
        return qmatmul_w8a16_plain(x, w, layer, **kw)
    launch = {"row": qmatmul_w8a16_row, "mma": qmatmul_w8a16_mma, "tc": qmatmul_w8a16_tc}
    return launch[route(x.numel() // x.shape[-1])](x, w, layer, **kw)


def _prepare(x, w, layer, norm_w, eps, residual, swiglu) -> dict:
    """The checked arguments of one launch of either route, for a CUDA ``x``."""
    if norm_w is not None and swiglu:
        raise ValueError("qmatmul_w8a16: one prologue at a time (norm_w or swiglu)")
    _need(x.device.type == "cuda", f"tensors on {x.device} are neither CPU nor CUDA")
    codes, scales = w.q, w.scales
    q4 = isinstance(w, Q4Tensor)
    stacked = codes.dim() == 3
    _need(codes.dim() in (2, 3) and scales.dim() == codes.dim(), "weights must be [N, D] or [L, N, D]")
    if stacked:
        _need(layer is not None and 0 <= layer < codes.shape[0], f"layer {layer} out of range")
    else:
        _need(layer is None, "a layer index needs stacked weights")
    n, d = w.shape[-2:]
    groups = scales.shape[-2]
    _need(n % groups == 0 and scales.shape[-1] == d, f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    g = n // groups
    _need(not q4 or g % 2 == 0, f"INT4 group size {g} must be even")
    _need(n % 8 == 0 and d % 16 == 0, f"N={n} must be a multiple of 8, D={d} of 16")
    code_dtype = torch.uint8 if q4 else torch.int8
    _need(codes.dtype == code_dtype and codes.is_contiguous(), f"codes must be contiguous {code_dtype}")
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
        "(longer windows take qmatmul_w8a16_rows)",
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
    prologue = "rms" if norm_w is not None else ("swiglu" if swiglu else None)
    return {
        "x2": x2, "res": res, "rows": rows, "n": n, "d": d, "g": g, "q4": q4, "dev": dev,
        "codes": codes.data_ptr() + li * codes.shape[-2] * d, "scales": scales.data_ptr() + li * groups * d * 2,
        "nw": nw_ptr, "prologue": _PROLOGUES[prologue], "out_shape": (*x.shape[:-1], d),
    }


def qmatmul_w8a16_row(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None, *,
                      norm_w: torch.Tensor | None = None, eps: float = 1e-6,
                      residual: torch.Tensor | None = None, swiglu: bool = False) -> torch.Tensor:
    """``qmatmul_w8a16`` on the row kernel (its route at one row), for
    exactly one activation row; its launches count under ``qmatmul_w8a16``."""
    if x.device.type == "cpu":
        return qmatmul_w8a16(x, w, layer, norm_w=norm_w, eps=eps, residual=residual, swiglu=swiglu)
    a = _prepare(x, w, layer, norm_w, eps, residual, swiglu)
    n, d, dev, res, g, q4 = a["n"], a["d"], a["dev"], a["res"], a["g"], a["q4"]
    _need(a["rows"] == 1, f"the row kernel takes one activation row, not {a['rows']}")
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    uniform = (g // 2) % 2 == 0 if q4 else g % 4 == 0
    splits, spb = row_plan(n, d, g, q4, _sm_count(index), _row_blocks_per_sm(index, q4, uniform))
    out = torch.empty(1, d, dtype=torch.float32, device=dev)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * d, dtype=torch.float32, device=dev)
        counters = _mma_counters(dev, -(-d // _ROW_BLOCK_COLS))
    err = _lib().qmatmul_w8a16_row(
        a["x2"].data_ptr(), int(a["x2"].dtype == torch.bfloat16), a["codes"], a["scales"], a["nw"],
        None if res is None else res.data_ptr(), int(res is not None and res.dtype == torch.bfloat16),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        n, d, g, a["prologue"], float(eps), int(q4), spb, splits, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "qmatmul_w8a16_row")
    LAUNCHES["qmatmul_w8a16_q4" if q4 else "qmatmul_w8a16"] += 1
    return out.reshape(a["out_shape"])


_MMA_COUNTERS: dict = {}


def _mma_counters(dev: torch.device, strips: int) -> torch.Tensor:
    """The split counters of the mma and row kernels on ``dev``: one zero
    int per 128-column strip, made once (grown when a wider weight needs
    more); each launch leaves them zero.  The one-call probe kernel takes
    one per (pass, strip) from the same buffer."""
    t = _MMA_COUNTERS.get(dev)
    if t is None or t.numel() < strips:
        t = _MMA_COUNTERS[dev] = torch.zeros(max(strips, 2048), dtype=torch.int32, device=dev)
    return t


def qmatmul_w8a16_mma(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None, *,
                      norm_w: torch.Tensor | None = None, eps: float = 1e-6,
                      residual: torch.Tensor | None = None, swiglu: bool = False) -> torch.Tensor:
    """``qmatmul_w8a16`` on the mma kernel (its route from ``MMA_MIN_ROWS``
    to ``TC_MIN_ROWS - 1`` rows), at any 1..16 rows."""
    if x.device.type == "cpu":
        return qmatmul_w8a16(x, w, layer, norm_w=norm_w, eps=eps, residual=residual, swiglu=swiglu)
    a = _prepare(x, w, layer, norm_w, eps, residual, swiglu)
    rows, n, d, dev, res = a["rows"], a["n"], a["d"], a["dev"], a["res"]
    splits, spb = mma_plan(n, d, rows, _sm_count(dev.index or 0))
    out = torch.empty(rows, d, dtype=torch.float32, device=dev)
    xs = torch.empty(rows, -(-n // _MMA_SLICE) * _MMA_SLICE, dtype=torch.bfloat16, device=dev)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * rows * d, dtype=torch.float32, device=dev)
        counters = _mma_counters(dev, -(-d // _MMA_BLOCK_COLS))
    err = _lib().qmatmul_w8a16_mma(
        a["x2"].data_ptr(), int(a["x2"].dtype == torch.bfloat16), xs.data_ptr(), a["codes"], a["scales"], a["nw"],
        None if res is None else res.data_ptr(), int(res is not None and res.dtype == torch.bfloat16),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        rows, n, d, a["g"], a["prologue"], float(eps), int(a["q4"]), spb, splits,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "qmatmul_w8a16_mma")
    LAUNCHES["qmatmul_w8a16_mma_q4" if a["q4"] else "qmatmul_w8a16_mma"] += 1
    return out.reshape(a["out_shape"])


def qmatmul_w8a16_tc(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None, *,
                     norm_w: torch.Tensor | None = None, eps: float = 1e-6,
                     residual: torch.Tensor | None = None, swiglu: bool = False) -> torch.Tensor:
    """``qmatmul_w8a16`` on the tensor-core kernel (its route from
    ``TC_MIN_ROWS`` rows on), at any 1..256 rows."""
    if x.device.type == "cpu":
        return qmatmul_w8a16(x, w, layer, norm_w=norm_w, eps=eps, residual=residual, swiglu=swiglu)
    a = _prepare(x, w, layer, norm_w, eps, residual, swiglu)
    rows, n, d, dev, res = a["rows"], a["n"], a["d"], a["dev"], a["res"]
    tile, splits, kts = tc_plan(n, d, rows, _sm_count(dev.index or 0))
    out = torch.empty(rows, d, dtype=torch.float32, device=dev)
    xs = torch.empty(rows, -(-n // _TC_SLOTS) * _TC_SLOTS, dtype=torch.bfloat16, device=dev)
    partial = torch.empty(splits * rows * d, dtype=torch.float32, device=dev) if splits > 1 else None
    err = _lib().qmatmul_w8a16_tc(
        a["x2"].data_ptr(), int(a["x2"].dtype == torch.bfloat16), xs.data_ptr(), a["codes"], a["scales"],
        a["nw"], None if res is None else res.data_ptr(), int(res is not None and res.dtype == torch.bfloat16),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        rows, n, d, a["g"], a["prologue"], float(eps), int(a["q4"]), tile, splits, kts,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "qmatmul_w8a16_tc")
    LAUNCHES["qmatmul_w8a16_tc_q4" if a["q4"] else "qmatmul_w8a16_tc"] += 1
    return out.reshape(a["out_shape"])


# ------------------------------------------------------------ row-blocked W8A16
def _check_out_cols(out_cols, d: int) -> tuple[int, int]:
    """``out_cols=(c0, dc)`` checked against ``d`` columns (None: all of them).
    The window starts on a 128-column tile, as the tensor-parallel overlap's
    chunks do, and stays inside the weight."""
    if out_cols is None:
        return 0, d
    c0, dc = (int(c) for c in out_cols)
    if c0 < 0 or c0 % 128 or dc <= 0 or dc % 16 or c0 + dc > d:
        raise ValueError(
            f"qmatmul_w8a16_rows: out_cols ({c0}, {dc}) must start on a multiple of 128, "
            f"span a positive multiple of 16 and end by D={d}"
        )
    return c0, dc


def qmatmul_w8a16_rows_plain(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None, *,
                             out_cols: tuple[int, int] | None = None) -> torch.Tensor:
    """Plain PyTorch version of the row-blocked kernel: x rounded to bf16,
    each weight element ``bf16(code · bf16(scale))``, f32 sums.  It is the
    fused kernel's plain version without prologue or residual; ``out_cols``
    slices the weight's columns first."""
    c0, dc = _check_out_cols(out_cols, w.shape[-1])
    if (c0, dc) != (0, w.shape[-1]):
        w = type(w)(w.q[..., c0 : c0 + dc], w.scales[..., c0 : c0 + dc])
    return qmatmul_w8a16_plain(x, w, layer)


@functools.cache
def _rows_lib() -> ctypes.CDLL:
    lib = build.load("qmatmul_rows")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.qmatmul_w8a16_rows.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    lib.qmatmul_w8a16_rows.restype = ctypes.c_int
    return lib


def _layer_on_card(w, layer, what: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Codes and scales of one layer as views (no copy of the codes), checked
    for the card's kernels; INT4 codes stay packed ``[N/2, D]``."""

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{what}: {msg}")

    need(w.q.dim() in (2, 3) and w.scales.dim() == w.q.dim(), "weights must be [N, D] or [L, N, D]")
    if w.q.dim() == 3:
        need(layer is not None and 0 <= layer < w.q.shape[0], f"layer {layer} out of range")
    else:
        need(layer is None, "a layer index needs stacked weights")
    codes, scales = _layer_of(w, layer)
    code_dtype = torch.uint8 if isinstance(w, Q4Tensor) else torch.int8
    need(codes.dtype == code_dtype and codes.is_contiguous(), f"codes must be contiguous {code_dtype}")
    n, d = w.shape[-2:]
    need(n % scales.shape[0] == 0 and scales.shape[1] == d,
         f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    need(d % 16 == 0, f"D={d} must be a multiple of 16")
    need(codes.data_ptr() % 16 == 0, "codes must be 16-byte aligned")
    return codes, scales


def qmatmul_w8a16_rows(x: torch.Tensor, w: QuantizedTensor, layer: int | None = None, *,
                       out_cols: tuple[int, int] | None = None) -> torch.Tensor:
    """``x [..., N]`` times layer ``layer`` of ``w`` (a ``QuantizedTensor`` or
    a ``Q4Tensor``) → ``[..., D]`` f32, for windows of any number of rows
    (the engine sends it those over ``MAX_ROWS``).  Scales may be bf16 or
    f32; f32 scales are rounded to bf16, as the reference kernel rounds them
    in its body.

    ``out_cols=(c0, dc)`` computes only columns ``[c0, c0+dc)`` → ``[..., dc]``
    (INT8 weights: the tensor-parallel overlap's chunks), reading only those
    columns of the weight; its launches count under
    ``qmatmul_w8a16_rows_cols``."""
    if x.device.type == "cpu":
        return qmatmul_w8a16_rows_plain(x, w, layer, out_cols=out_cols)
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul_w8a16_rows: tensors on {x.device} are neither CPU nor CUDA")
    codes, scales = _layer_on_card(w, layer, "qmatmul_w8a16_rows")
    q4 = isinstance(w, Q4Tensor)
    n, d = w.shape[-2:]
    c0, dc = _check_out_cols(out_cols, d)
    if out_cols is not None and q4:
        raise ValueError("qmatmul_w8a16_rows: out_cols takes INT8 weights (INT4 slices them and takes the plain path)")
    g = n // scales.shape[0]
    if n % 64 or x.shape[-1] != n:
        raise ValueError(f"qmatmul_w8a16_rows: x width {x.shape[-1]} must be N={n}, a multiple of 64")
    if q4 and g % 2:
        raise ValueError(f"qmatmul_w8a16_rows: INT4 group size {g} must be even")
    sb = scales.to(torch.bfloat16).contiguous()
    x2 = x.reshape(-1, n).to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()  # the kernel reads x in 16-byte pieces
    if not (x2.device == codes.device == sb.device):
        raise ValueError("qmatmul_w8a16_rows: all tensors must be on one device")
    rows = x2.shape[0]
    out = torch.empty(rows, dc, dtype=torch.float32, device=x.device)
    if rows:
        # INT4 with g != 64: x staged in the kernel's slot order (g == 64 is x's own order).
        xs = torch.empty_like(x2) if q4 and g != 64 else None
        err = _rows_lib().qmatmul_w8a16_rows(
            x2.data_ptr(), None if xs is None else xs.data_ptr(), codes.data_ptr(), sb.data_ptr(), out.data_ptr(),
            rows, n, d, c0, dc, g, int(q4), torch.cuda.current_stream(x.device).cuda_stream,
        )
        build.check(err, "qmatmul_w8a16_rows")
        key = "qmatmul_w8a16_rows_cols" if out_cols is not None else "qmatmul_w8a16_rows"
        LAUNCHES[key + "_q4" if q4 else key] += 1
    return out.reshape(*x.shape[:-1], dc)


# ------------------------------------------------------------------- dequant
def dequant_w8_stacked_plain(w: QuantizedTensor, layer: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: ``bf16(code · scale)``, the product in f32 and
    rounded once (f32 scales unrounded)."""
    codes, scales = _layer_of(w, layer)
    g = codes.shape[0] // scales.shape[0]
    return (codes.float() * scales.float().repeat_interleave(g, dim=0)).to(torch.bfloat16)


@functools.cache
def _dequant_lib() -> ctypes.CDLL:
    lib = build.load("dequant")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dequant_w8, lib.dequant_q4):
        fn.argtypes = [p, p, i, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def dequant_w8_stacked(w: QuantizedTensor, layer: int | None = None) -> torch.Tensor:
    """Layer ``layer`` of ``w`` (or a 2-D weight) → dense bf16 ``[N, D]``."""
    if isinstance(w, Q4Tensor):
        raise ValueError("dequant_w8_stacked: INT4 weights take dequant_q4_stacked")
    if w.q.device.type == "cpu":
        return dequant_w8_stacked_plain(w, layer)
    if w.q.device.type != "cuda":
        raise ValueError(f"dequant_w8_stacked: tensors on {w.q.device} are neither CPU nor CUDA")
    codes, scales = _layer_on_card(w, layer, "dequant_w8_stacked")
    if scales.dtype not in (torch.float32, torch.bfloat16) or not scales.is_contiguous():
        raise ValueError("dequant_w8_stacked: scales must be contiguous f32 or bf16")
    n, d = codes.shape
    out = torch.empty(n, d, dtype=torch.bfloat16, device=codes.device)
    err = _dequant_lib().dequant_w8(
        codes.data_ptr(), scales.data_ptr(), int(scales.dtype == torch.float32), out.data_ptr(),
        n, d, n // scales.shape[0], torch.cuda.current_stream(codes.device).cuda_stream,
    )
    build.check(err, "dequant_w8_stacked")
    LAUNCHES["dequant_w8_stacked"] += 1
    return out


def dequant_q4_stacked_plain(w: Q4Tensor, layer: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of the Q4 dequant: ``bf16(code · bf16(scale))``,
    the scales rounded to bf16 first (the reference's "int" unpack; the
    product of a 4-bit code and a bf16 scale is exact in f32)."""
    codes, scales = _layer_of(w, layer)
    g = w.group_size
    sb = scales.to(torch.bfloat16).float().repeat_interleave(g, dim=0)
    return (unpack_q4(codes, g).float() * sb).to(torch.bfloat16)


def dequant_q4_stacked(w: Q4Tensor, layer: int | None = None) -> torch.Tensor:
    """Layer ``layer`` of INT4 ``w`` (or a 2-D weight) → dense bf16 ``[N, D]``."""
    if not isinstance(w, Q4Tensor):
        raise ValueError("dequant_q4_stacked: INT8 weights take dequant_w8_stacked")
    if w.q.device.type == "cpu":
        return dequant_q4_stacked_plain(w, layer)
    if w.q.device.type != "cuda":
        raise ValueError(f"dequant_q4_stacked: tensors on {w.q.device} are neither CPU nor CUDA")
    codes, scales = _layer_on_card(w, layer, "dequant_q4_stacked")
    if scales.dtype not in (torch.float32, torch.bfloat16) or not scales.is_contiguous():
        raise ValueError("dequant_q4_stacked: scales must be contiguous f32 or bf16")
    n, d = w.shape[-2:]
    g = n // scales.shape[0]
    if g % 2:
        raise ValueError(f"dequant_q4_stacked: INT4 group size {g} must be even")
    out = torch.empty(n, d, dtype=torch.bfloat16, device=codes.device)
    err = _dequant_lib().dequant_q4(
        codes.data_ptr(), scales.data_ptr(), int(scales.dtype == torch.float32), out.data_ptr(),
        n, d, g, torch.cuda.current_stream(codes.device).cuda_stream,
    )
    build.check(err, "dequant_q4_stacked")
    LAUNCHES["dequant_q4_stacked"] += 1
    return out
