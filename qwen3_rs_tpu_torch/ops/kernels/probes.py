"""The four measurement probes' kernels, each beside its plain version.

The reference package measures its chip with four Pallas probes under
``scripts/``; the port measures the card with these kernels, driven by
``qwen3_rs_tpu_torch.scripts``.  Each computes a value that its plain
version recomputes, so that a probe's time belongs to a checked result:

* ``boundary_onecall`` (``scripts/boundary_probe.py:98``): ``x · dequant(W[l])``
  for every layer of a stacked INT8 weight, all layers streamed ``reps``
  times by one launch; layer ``l`` equals #2 (``qmatmul_w8a16(x, w, l)``).
* ``hbm_stream`` (``scripts/hbm_stream_bench.py:57``): the exact int64 sum of
  every byte of an int8 array, each block streaming ``span_bytes`` of it.
* ``head_a8`` (``scripts/head_a8_probe.py:99``): the decode classifier's
  compute path on resident tiles, as ``deq-dot``, ``i8-seg`` or ``i8-seg2``.
* ``a8_depth`` (``scripts/a8_depth_probe.py:90``): ``x · w^T`` as
  ``bf16-full``, ``i8-seg64`` (int32 flushed into f32 every 64 rows of depth)
  or ``i8-full`` (flushed every 512).

For a CPU tensor each wrapper runs its plain PyTorch version; for a CUDA
tensor it launches ``csrc/<probe>.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import QuantizedTensor
from . import LAUNCHES, build
from .qmatmul import _ROW_BLOCK_COLS, _ROW_SCALE_ROW, _ROW_SLICE, _ROW_WARPS, _mma_counters, qmatmul_w8a16_plain

HEAD_A8_VARIANTS = ("deq-dot", "i8-seg", "i8-seg2")
A8_DEPTH_VARIANTS = ("bf16-full", "i8-seg64", "i8-full")
HEAD_A8_GROUP = 64
A8_SEG_DEPTH = {"i8-seg64": 64, "i8-full": 512}  # int32 depth before each flush into f32
# Each kernel against its plain version, relative to the largest value.  The tensor cores'
# f32 accumulation (deq-dot, bf16-full) rounds toward zero, not to nearest: over thousands of
# k-steps it drifts by ~2e-5, so these take #6's tolerance (1e-4).  The int8 dots are exact:
# i8-seg's f32 fixups differ only in summation order (1e-5), a8_depth's int arms not at all.
HEAD_A8_RTOL = {"deq-dot": 1e-4, "i8-seg": 1e-5, "i8-seg2": 1e-5}
# P3's unit of work (csrc/head_a8_probe.cu): 16 weight columns (an m16 tile) by one 64-row group of
# one tile; a block holds up to 96 units in shared memory, with the activations.
HEAD_A8_UNIT_COLS = 16
_HEAD_A8_MAX_UNITS = 96
_HEAD_A8_UNIT_BYTES = HEAD_A8_UNIT_COLS * 64 + HEAD_A8_UNIT_COLS * 4  # codes and scales
_HEAD_A8_SMEM = 226 * 1024
A8_DEPTH_RTOL = {"bf16-full": 1e-4, "i8-seg64": 0.0, "i8-full": 0.0}
# The one-call kernel (P1) has the row kernel's blocks (qmatmul._ROW_*: 128 output columns by a
# split's 16-row k-slices, a multiple of 8, one run a warp); its dynamic shared memory, x's bf16
# slots and two buffers of scale rows, stays within 64 KB so that three blocks fit an SM.
_ONECALL_SMEM_CAP = 64 * 1024
_ONECALL_SMEM_MAX = 227 * 1024  # one block an SM, where x alone leaves no room under the cap
_ONECALL_FILL = 0.9  # the share of its waves of resident blocks that a plan's units must fill
_ONECALL_WALK = 6  # a unit's record: block, layer, columns [c0, c1), contraction rows [r0, r1)
# P4: the tile of each arm (x rows, output columns), its k-tile (128 bytes of depth), and the int
# arms' 64-deep groups, flushed every A8_SEG_DEPTH rows.
A8_DEPTH_TILE = {"bf16-full": (128, 256), "i8-seg64": (128, 128), "i8-full": (128, 128)}
A8_K_TILE_BYTES = 128
A8_GROUP = 64
_MAX_SPAN = 16 << 20  # the stream kernel's largest span a block


def _need(cond: bool, who: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _on_card(t: torch.Tensor, who: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for CUDA; raises otherwise."""
    if t.device.type == "cpu":
        return False
    _need(t.device.type == "cuda", who, f"tensors on {t.device} are neither CPU nor CUDA")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i, l_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    sigs = {
        "boundary_probe": ("boundary_onecall", [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]),
        "hbm_stream_bench": ("hbm_stream", [p, l_, l_, p, p, p]),
        "head_a8_probe": ("head_a8", [i, p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]),
        "a8_depth_probe": ("a8_depth", [i, p, p, p, i, i, i, p]),
    }
    fn, args = sigs[name]
    getattr(lib, fn).argtypes = args
    getattr(lib, fn).restype = ctypes.c_int
    if name == "boundary_probe":
        lib.boundary_onecall_blocks_per_sm.argtypes = [i, i]
        lib.boundary_onecall_blocks_per_sm.restype = ctypes.c_int
    if name == "head_a8_probe":
        lib.head_a8_grid.argtypes = [i, i, i, i, i]
        lib.head_a8_grid.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------------ P1: onecall
def boundary_onecall_plain(x: torch.Tensor, w: QuantizedTensor, reps: int = 1) -> torch.Tensor:
    """``[L, D]`` f32: row ``l`` is #2's plain version on layer ``l`` (each
    rep writes the same values)."""
    return torch.stack([qmatmul_w8a16_plain(x.reshape(1, -1), w, l)[0] for l in range(w.q.shape[0])])


def onecall_smem(n: int, spb: int, g: int) -> int:
    """Dynamic shared memory of a one-call block (``smem_bytes`` in its source):
    x's bf16 slots (N rounded up to 16), then two buffers of the scale rows
    that a unit of ``spb`` k-slices touches (at most ``spb·16/g + 2``)."""
    kp = -(-n // _ROW_SLICE) * _ROW_SLICE
    return 2 * kp + 2 * (-(-(spb * _ROW_SLICE // g + 2) * _ROW_SCALE_ROW // 16) * 16)


@functools.cache
def onecall_plan(n: int, d: int, g: int, layers: int, sms: int, per_sm: int) -> tuple[int, int, int]:
    """(splits, k-slices per split, grid) of the one-call kernel for ``layers``
    stacked ``[N, D]`` weights on ``sms`` SMs holding ``per_sm`` of its blocks.

    A unit is a 128-column strip of one layer by a split of its k-slices, as
    a row-kernel block is; the grid walks a pass's units, pass after pass,
    unit u on block ``u % grid``.  The plan takes the fewest splits whose
    ``layers · strips · splits`` units fill at least ``_ONECALL_FILL`` of the
    whole waves of resident blocks they take, else the plan that fills the
    most; the grid is one wave, or the units of a rep where they are fewer.
    Where x's slots leave no room for a unit's scale rows under the 64 KB
    that lets three blocks share an SM, a block takes up to 227 KB alone."""
    slices = -(-n // _ROW_SLICE)
    strips = -(-d // _ROW_BLOCK_COLS)
    cap = _ONECALL_SMEM_CAP
    if onecall_smem(n, _ROW_WARPS, g) > cap:
        cap, per_sm = _ONECALL_SMEM_MAX, 1
    plans = []  # (splits, spb) by increasing splits, each split count once
    for want in range(1, slices + 1):
        spb = -(-(-(-slices // want)) // _ROW_WARPS) * _ROW_WARPS
        if -(-slices // spb) == want and onecall_smem(n, spb, g) <= cap:
            plans.append((want, spb))
    if not plans:
        raise ValueError(f"boundary_onecall: N={n} at g={g} leaves no room for a block's shared memory")
    wave = per_sm * sms

    def fill(plan):
        units = layers * strips * plan[0]
        return units / (-(-units // wave) * wave)

    good = [p for p in plans if fill(p) >= _ONECALL_FILL]
    splits, spb = good[0] if good else max(plans, key=fill)
    return splits, spb, min(layers * strips * splits, wave)


def onecall_walk(n: int, d: int, layers: int, splits: int, spb: int, grid: int) -> list[tuple[int, ...]]:
    """The one-call kernel's units of one rep, in walk order, as the kernel
    records them: (block, layer, first column, end column, first
    contraction row, end row); the kernel repeats them each rep."""
    slices = -(-n // _ROW_SLICE)
    strips = -(-d // _ROW_BLOCK_COLS)
    out = []
    for u in range(layers * strips * splits):
        layer, r = divmod(u, strips * splits)
        strip, split = divmod(r, splits)
        s0 = split * spb
        ns = min(slices - s0, spb)
        c0 = strip * _ROW_BLOCK_COLS
        out.append((u % grid, layer, c0, min(c0 + _ROW_BLOCK_COLS, d), _ROW_SLICE * s0,
                    min(_ROW_SLICE * (s0 + ns), n)))
    return out


@functools.cache
def _onecall_per_sm(index: int, uniform: bool) -> int:
    """One-call blocks that one SM of card ``index`` holds at 64 KB of shared
    memory each, at most 3."""
    with torch.cuda.device(index):
        n = _lib("boundary_probe").boundary_onecall_blocks_per_sm(int(uniform), _ONECALL_SMEM_CAP)
    if n < 1:
        raise RuntimeError("boundary_onecall: the occupancy query failed")
    return min(n, 3)


def boundary_onecall(x: torch.Tensor, w: QuantizedTensor, reps: int = 1) -> torch.Tensor:
    """x f32 ``[1, N]`` (or ``[N]``) times every layer of ``w`` (int8 codes
    ``[L, N, D]``, bf16 scales ``[L, N/g, D]``), the ``L`` layers streamed
    ``reps`` times in one launch → ``[L, D]`` f32."""
    return _onecall(x, w, reps, walk=False)[0]


def boundary_onecall_walk(x: torch.Tensor, w: QuantizedTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``boundary_onecall(x, w, 1)`` and the kernel's record of its walk
    (int32 ``[units, 6]``, as ``onecall_walk`` lists it); card only."""
    _need(x.device.type == "cuda", "boundary_onecall", "the walk is the card kernel's")
    return _onecall(x, w, 1, walk=True)


def _onecall(x: torch.Tensor, w: QuantizedTensor, reps: int, walk: bool):
    who = "boundary_onecall"
    _need(reps >= 1, who, f"reps {reps} < 1")
    if not _on_card(x, who):
        return boundary_onecall_plain(x, w, reps), None
    codes, scales = w.q, w.scales
    _need(codes.dim() == 3 and scales.dim() == 3, who, "weights must be stacked [L, N, D]")
    layers, n, d = codes.shape
    _need(n % scales.shape[1] == 0 and scales.shape[0] == layers and scales.shape[2] == d, who,
          f"scales {tuple(scales.shape)} do not fit codes {tuple(codes.shape)}")
    g = n // scales.shape[1]
    _need(n % 8 == 0 and d % 32 == 0, who, f"N={n} must be a multiple of 8, D={d} of 32")
    _need(codes.dtype == torch.int8 and codes.is_contiguous(), who, "codes must be contiguous int8")
    _need(scales.dtype == torch.bfloat16 and scales.is_contiguous(), who, "scales must be contiguous bf16")
    _need(x.dtype == torch.float32 and x.numel() == n, who, f"x must be f32 with N={n} values")
    _need(x.device == codes.device == scales.device, who, "all tensors must be on one device")
    dev = x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    splits, spb, grid = onecall_plan(n, d, g, layers, _sm_count(index), _onecall_per_sm(index, g % 4 == 0))
    passes, strips = reps * layers, -(-d // _ROW_BLOCK_COLS)
    xc = x.reshape(n).contiguous()
    y = torch.empty(layers, d, dtype=torch.float32, device=dev)
    partial = counters = None
    if splits > 1:
        partial = torch.empty(passes * splits * d, dtype=torch.float32, device=dev)
        counters = _mma_counters(dev, passes * strips)  # one per (pass, strip)
    rec = torch.full((layers * strips * splits, _ONECALL_WALK), -1, dtype=torch.int32, device=dev) if walk else None
    err = _lib("boundary_probe").boundary_onecall(
        xc.data_ptr(), codes.data_ptr(), scales.data_ptr(), y.data_ptr(),
        None if partial is None else partial.data_ptr(), None if counters is None else counters.data_ptr(),
        None if rec is None else rec.data_ptr(), n, d, g, layers, passes, splits, spb, grid, _stream(x))
    build.check(err, who)
    LAUNCHES["boundary_onecall"] += 1
    return y, rec


# ------------------------------------------------------------------- P2: stream
def hbm_stream_plain(x: torch.Tensor, span_bytes: int) -> torch.Tensor:
    """The int64 sum of every byte of ``x`` (the span only splits the work)."""
    return x.sum(dtype=torch.int64)


def hbm_stream(x: torch.Tensor, span_bytes: int) -> torch.Tensor:
    """Sum of every byte of the contiguous int8 tensor ``x`` as a 0-d int64
    tensor, each block of the launch streaming ``span_bytes`` of it."""
    who = "hbm_stream"
    _need(span_bytes > 0 and span_bytes % 16 == 0 and span_bytes <= _MAX_SPAN, who,
          f"span of {span_bytes} bytes must be a positive multiple of 16 up to {_MAX_SPAN}")
    if not _on_card(x, who):
        return hbm_stream_plain(x, span_bytes)
    _need(x.dtype == torch.int8 and x.is_contiguous(), who, "x must be contiguous int8")
    n = x.numel()
    _need(n > 0 and n % 16 == 0 and x.data_ptr() % 16 == 0, who, f"{n} bytes must be a positive multiple of 16")
    blocks = -(-n // span_bytes)
    partial = torch.empty(blocks, dtype=torch.int64, device=x.device)
    out = torch.empty((), dtype=torch.int64, device=x.device)
    err = _lib("hbm_stream_bench").hbm_stream(x.data_ptr(), n, span_bytes, partial.data_ptr(), out.data_ptr(),
                                              _stream(x))
    build.check(err, who)
    LAUNCHES["hbm_stream"] += 1
    return out


# ------------------------------------------------------------------ P3: head_a8
def head_a8_plain(variant: str, x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor, sweeps: int | None = None) -> torch.Tensor:
    """The JAX probe's kernel body on the same inputs: each tile's part in
    f32 (``deq-dot``: ``x · bf16(code · bf16(scale))``; the int8 arms: the
    groups' exact int8 dots, each times its scale row (and x-scale column),
    summed in group order), the sweeps' parts summed in sweep order."""
    n_tiles, tn, td = w.shape
    b = x.shape[0]
    tg = tn // HEAD_A8_GROUP
    parts = []
    for t in range(n_tiles):
        if variant == "deq-dot":
            sc = s[t].to(torch.bfloat16).float().repeat_interleave(HEAD_A8_GROUP, dim=0)
            wf = (w[t].float() * sc).to(torch.bfloat16).float()
            parts.append(x.float() @ wf)
            continue
        # Each group's int8 dot is an integer below 2^24: exact in f32.
        d = torch.bmm(xq.float().reshape(b, tg, HEAD_A8_GROUP).transpose(0, 1),
                      w[t].float().reshape(tg, HEAD_A8_GROUP, td))  # [tg, B, TD]
        acc = torch.zeros(b, td, dtype=torch.float32, device=x.device)
        for g in range(tg):
            fix = d[g] * s[t, g][None, :]
            if variant == "i8-seg":
                fix = fix * xs[:, g : g + 1]
            acc = acc + fix
        parts.append(acc)
    o = torch.zeros(b, td, dtype=torch.float32, device=x.device)
    for sw in range(n_tiles * 16 if sweeps is None else sweeps):
        o = o + parts[sw % n_tiles]
    return o


def head_a8_smem(variant: str, tn: int, units: int) -> int:
    """Dynamic shared memory of a P3 block of ``units`` units (``smem_bytes``
    in its source): each unit's 1 KB of codes and 16 scales, then the
    activations (deq-dot: B fragments, 1 KB a group; the int arms: 8 xq rows
    of tn + 64 bytes and 8 x-scales a group)."""
    groups = tn // HEAD_A8_GROUP
    acts = groups * 1024 if variant == "deq-dot" else 8 * (tn + 64) + groups * 8 * 4
    return units * _HEAD_A8_UNIT_BYTES + acts


def head_a8_grid(variant: str, tn: int, td: int, n_tiles: int, sms: int) -> int:
    """Blocks of a P3 launch, the mirror of ``head_a8_grid`` in its source
    (which the wrapper calls; the card test holds the two equal): the units
    (``n_tiles · td/16 · tn/64``) cut into equal ranges, one an SM, fewer
    where there are fewer units, more where a range would pass a block's
    shared memory or its 96 units; 0 where no block holds one unit."""
    units = n_tiles * (td // HEAD_A8_UNIT_COLS) * (tn // HEAD_A8_GROUP)
    cap = min(_HEAD_A8_MAX_UNITS, (_HEAD_A8_SMEM - head_a8_smem(variant, tn, 0)) // _HEAD_A8_UNIT_BYTES)
    if cap < 1:
        return 0
    return max(-(-units // cap), min(units, sms))


def head_a8_plan(tn: int, td: int, n_tiles: int, grid: int) -> list[list[tuple[int, int, int]]]:
    """Each block's units as the kernel cuts them: the units in (tile,
    16-column tile, group) order, block i taking ``[i·U // grid, (i+1)·U //
    grid)``; a unit is (tile, first column, first row)."""
    m, c = td // HEAD_A8_UNIT_COLS, tn // HEAD_A8_GROUP
    n = n_tiles * m * c
    return [[(u // (m * c), u // c % m * HEAD_A8_UNIT_COLS, u % c * HEAD_A8_GROUP)
             for u in range(i * n // grid, (i + 1) * n // grid)] for i in range(grid)]


def head_a8_workspace_floats(grid: int, td: int, n_tiles: int, b: int) -> int:
    """Floats of a P3 launch's partials: block i writes the B·16 sums of each
    (tile, column tile) pair p its units touch to slot i + p."""
    return (grid + n_tiles * (td // HEAD_A8_UNIT_COLS)) * b * HEAD_A8_UNIT_COLS


def head_a8(variant: str, x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
            s: torch.Tensor, sweeps: int | None = None) -> torch.Tensor:
    """x bf16 ``[B, TN]``, xq int8 ``[B, TN]``, xs f32 ``[B, TN/64]``, w int8
    ``[n_tiles, TN, TD]``, s f32 ``[n_tiles, TN/64, TD]`` → f32 ``[B, TD]``,
    the sum over ``sweeps`` (default ``n_tiles·16``) sweeps of tile
    ``sweep % n_tiles`` of ``variant``'s product.  On the card one launch
    of ``head_a8_grid`` blocks (``head_a8_plan``), the split sums merged in
    a fixed order, the column tiles' counters left zero."""
    who = "head_a8"
    _need(variant in HEAD_A8_VARIANTS, who, f"variant {variant!r} is none of {HEAD_A8_VARIANTS}")
    _need(w.dim() == 3, who, "w must be [n_tiles, TN, TD]")
    n_tiles, tn, td = w.shape
    b = x.shape[0]
    sweeps = n_tiles * 16 if sweeps is None else sweeps
    _need(sweeps >= 1, who, f"sweeps {sweeps} < 1")
    if not _on_card(x, who):
        return head_a8_plain(variant, x, xq, xs, w, s, sweeps)
    _need(1 <= b <= 8, who, f"B={b} must be 1..8")
    _need(tn % 512 == 0 and td % 16 == 0, who, f"TN={tn} must be a multiple of 512, TD={td} of 16")
    tg = tn // HEAD_A8_GROUP
    want = {"x": (x, torch.bfloat16, (b, tn)), "xq": (xq, torch.int8, (b, tn)), "xs": (xs, torch.float32, (b, tg)),
            "w": (w, torch.int8, (n_tiles, tn, td)), "s": (s, torch.float32, (n_tiles, tg, td))}
    for name, (t, dt, shape) in want.items():
        _need(t.dtype == dt and tuple(t.shape) == shape and t.is_contiguous(), who,
              f"{name} must be contiguous {dt} {list(shape)}, got {t.dtype} {list(t.shape)}")
        _need(t.device == x.device, who, "all tensors must be on one device")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    lib = _lib("head_a8_probe")
    grid = lib.head_a8_grid(HEAD_A8_VARIANTS.index(variant), tn, td, n_tiles, _sm_count(index))
    _need(grid > 0, who, f"TN={tn}: a block's shared memory holds no unit beside the activations")
    out = torch.empty(b, td, dtype=torch.float32, device=x.device)
    ws = torch.empty(head_a8_workspace_floats(grid, td, n_tiles, b), dtype=torch.float32, device=x.device)
    counters = _mma_counters(x.device, td // HEAD_A8_UNIT_COLS)
    err = lib.head_a8(HEAD_A8_VARIANTS.index(variant), x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.data_ptr(),
                      s.data_ptr(), out.data_ptr(), b, tn, td, n_tiles, sweeps, grid, ws.data_ptr(),
                      counters.data_ptr(), _stream(x))
    build.check(err, who)
    LAUNCHES["head_a8"] += 1
    return out


# ----------------------------------------------------------------- P4: a8_depth
def a8_depth_plain(variant: str, x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """``x · wt^T`` in f32 as the kernel sums it: ``bf16-full`` in one f32
    product; the int8 arms per 64- or 512-deep segment (each an integer
    below 2^24, exact in f32), the segments added in depth order."""
    if variant == "bf16-full":
        return x.float() @ wt.float().T
    acc = torch.zeros(x.shape[0], wt.shape[0], dtype=torch.float32, device=x.device)
    for k0, k1 in a8_depth_flushes(variant, x.shape[1]):
        acc += x[:, k0:k1].float() @ wt[:, k0:k1].float().T
    return acc


def a8_depth_flushes(variant: str, k: int) -> list[tuple[int, int]]:
    """The int arms' flush segments ``[k0, k1)`` of a depth of ``k``, in
    depth order: ``A8_SEG_DEPTH`` rows each (whole 64-deep groups), the last
    cut at ``k``."""
    seg = A8_SEG_DEPTH[variant]
    return [(k0, min(k0 + seg, k)) for k0 in range(0, k, seg)]


def a8_depth_plan(variant: str, m: int, k: int, d: int) -> dict:
    """The kernel's tiling of ``x [m, k] · wt[d, k]^T`` (``k_tiles_of`` in
    ``csrc/a8_depth_probe.cu``): output tiles of ``A8_DEPTH_TILE`` (row tiles
    first; columns past ``d`` masked), k-tiles of 128 bytes of depth (those
    past ``k`` read zeros; i8-full walks whole 512-deep flush segments), and,
    for the int arms, 64-deep groups flushed along ``a8_depth_flushes``."""
    bm, bn = A8_DEPTH_TILE[variant]
    per_tile = A8_K_TILE_BYTES // (2 if variant == "bf16-full" else 1)
    k_tiles = -(-k // per_tile)
    if variant == "i8-full":
        k_tiles = -(-k // A8_SEG_DEPTH[variant]) * (A8_SEG_DEPTH[variant] // per_tile)
    plan = {"tile": (bm, bn), "tiles": (-(-m // bm), -(-d // bn)), "k_tile": per_tile, "k_tiles": k_tiles}
    if variant != "bf16-full":
        plan["groups"] = k // A8_GROUP
        plan["flushes"] = a8_depth_flushes(variant, k)
    return plan


def a8_depth(variant: str, x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x ``[M, K]`` times wt ``[D, K]`` (bf16 for ``bf16-full``, else int8)
    → f32 ``[M, D]``."""
    who = "a8_depth"
    _need(variant in A8_DEPTH_VARIANTS, who, f"variant {variant!r} is none of {A8_DEPTH_VARIANTS}")
    _need(x.dim() == 2 and wt.dim() == 2 and x.shape[1] == wt.shape[1], who,
          f"x {tuple(x.shape)} and wt {tuple(wt.shape)} must be [M, K] and [D, K]")
    if not _on_card(x, who):
        return a8_depth_plain(variant, x, wt)
    m, k = x.shape
    d = wt.shape[0]
    dt = torch.bfloat16 if variant == "bf16-full" else torch.int8
    _need(x.dtype == wt.dtype == dt and x.is_contiguous() and wt.is_contiguous(), who,
          f"x and wt must be contiguous {dt}")
    _need(m % 128 == 0 and d % 128 == 0 and k % 64 == 0, who,
          f"M={m} and D={d} must be multiples of 128, K={k} of 64")
    _need(x.device == wt.device, who, "all tensors must be on one device")
    out = torch.empty(m, d, dtype=torch.float32, device=x.device)
    err = _lib("a8_depth_probe").a8_depth(A8_DEPTH_VARIANTS.index(variant), x.data_ptr(), wt.data_ptr(),
                                          out.data_ptr(), m, k, d, _stream(x))
    build.check(err, who)
    LAUNCHES["a8_depth"] += 1
    return out
