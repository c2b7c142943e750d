"""GQA attention over the serving page pool: the Hopper kernels and their
plain versions.

The pool is stacked over layers, ``[L, P, n_kv, page, hd]``; cache row t of
request b is row ``t % page`` of page ``page_table[b, t // page]``, and only
rows ``t < pos[b]`` are valid.  An INT8 pool passes per-row scales
``[L, P, n_kv, page]``: the K scale multiplies the score, the V scale the
probability.

* ``paged_decode``: the S = 1 attention of one layer over rows < pos plus the
  step's own key and value, which are not cached yet.  It replaces the
  reference package's ``paged_gqa_decode_stacked``.
* ``paged_window_partials``: for a window of S query rows, the online-softmax
  partials (m, l, acc) of the cache part only.  It replaces the partials
  kernel of the reference package's ``paged_gqa_window_stacked``.
  ``paged_window_attention`` merges them with the causal attention inside
  the window in plain PyTorch, as the reference package merges them in XLA
  outside its kernel.

At every head_dim that is a multiple of 128 up to ``WIDE_MAX_HEAD_DIM``
over pages of a multiple of 16 rows (``split_kernel_takes``),
``paged_decode`` (and ``flash_decode`` over the dense cache, a layer viewed
as one page a request: ``one_launch`` without a table) is one launch of
``csrc/paged_decode.cu``: a grid that fills the card, split over the live
rows on the device (``decode_units`` is the plan in Python;
``paged_decode_kernel_plan`` reads the kernel's own), whole pages brought by
TMA, the splits merged by the last block of each (request, kv head, head
tile).  Its stage compute follows the pool: ``mma.sync`` for bf16 and INT8
pools (q and P in two bf16 terms, three for an INT8 dense layer:
``bf16_terms``), the CUDA cores for f32 pools, whose rows are not exact in
bf16.  At 128 and 256 (``SPLIT_HEAD_DIMS``) a stage is whole rows and each
warp keeps the whole O; past 256 (the kernel past 256) a stage is
``WIDE_ROWS`` rows, its K and its V a ring slot each
(``decode_wide_layout``), and each of hd / 128 consumer warps owns 128
columns: the warps' partial scores summed in shared memory, the same
softmax in each, P.V over a warp's own columns; a block takes every query
head of its kv head up to 8 (``decode_qm``), so each K/V row is read once.
``paged_window_partials`` over pages of a multiple of 16 rows, at every
head_dim and over every pool type
(``window_split_takes``: the window route's own head_dims, wider than the
decode's), is one launch of the window kernel of the same source, on the
same plan with row tiles of ``WINDOW_ROW_TILE`` query rows in place of head
tiles (``window_units``; ``paged_window_kernel_plan`` reads the kernel's
own): every query row of a tile shares each K/V row read, S and P·V on
``wgmma`` with q and P in bf16 hi + lo (an f32 pool's stage converted to
bf16 hi + lo too, each product in three terms).  Past head_dim 256 the
output's columns are cut into slices of ``WINDOW_WIDE_COLS``
(``window_slices``; the plan's tiles are the row tiles times the slices), S
is computed by 64-column bands with q's terms copied from a per-block
scratch (``window_q_scratch_bytes``), and ``window_wide_layout`` is the
block's shared memory.  Elsewhere both wrappers launch the two-pass kernels
of ``csrc/paged_attention.cu``, which share their first pass.
For a CPU tensor a wrapper runs its plain PyTorch version; for a CUDA tensor
it launches its kernel or raises.  They take any number of query heads per
kv head and every head_dim that is a multiple of 128 (``takes_head_dim``;
the two-pass kernels past 1024 in 128-column blocks); unlike the Pallas
kernels they take any page size (the JAX gate asks for multiples of 128).
"""

from __future__ import annotations

import ctypes
import functools
import statistics

import torch

from ..attention import _merge_window, gather_pages
from . import LAUNCHES, build
from .qmatmul import _sm_count

CHUNK = 128  # cache rows per block of the two-pass kernels' first pass
SPLIT_HEAD_DIMS = (128, 256)  # head_dims of the one-launch decode kernel's whole-row instances
SPLIT_ROWS = 16  # the one-launch kernel's split sizes and page sizes are multiples of it
WIDE_MAX_HEAD_DIM = 1024  # the decode kernel past 256 takes multiples of 128 up to this (one warp a 128 columns)
WIDE_ROWS = 16  # cache rows of a stage of the decode kernel past 256
WIDE_MAX_SLOTS = 12  # its ring slots at most (a slot holds a stage's K or its V)
WIDE_BLOCK_BYTES = 112 * 1024  # its block's shared memory at most where the ring has more than 2 slots
WINDOW_ROW_TILE = 64  # query rows a block of the one-launch window kernel takes
WINDOW_WIDE_COLS = 256  # output columns a block of the window kernel takes past head_dim 256
WINDOW_MIN_SPAN = 128  # a window split's least rows (2 stages): its partial is WINDOW_ROW_TILE rows by hd
MAX_WINDOW_ROWS = 128  # the reference's bound on S·kv_mul for the window kernel
_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_EXACT_INT8 = 3  # the one-launch kernel's cache type for an INT8 dense layer: q and P in three bf16 terms


def takes_head_dim(hd: int) -> bool:
    """Whether the kernels take head_dim ``hd``: every positive multiple of
    128, as the reference's gates admit (a template instance up to 512, the
    column-blocked kernels past it)."""
    return hd > 0 and hd % 128 == 0


def paged_decode_supported(head_dim: int, page_size: int, dtype) -> bool:
    """The reference package's gate for its paged decode kernel: a
    128-multiple head_dim and page, an f32, bf16 or INT8 pool."""
    return head_dim % 128 == 0 and page_size % 128 == 0 and dtype in _CACHE_TYPES


def window_supported(s: int, kv_mul: int) -> bool:
    """The window part of the reference's window gate: S > 1 and
    S·kv_mul ≤ 128."""
    return s > 1 and s * kv_mul <= MAX_WINDOW_ROWS


def paged_window_supported(head_dim: int, page_size: int, dtype, s: int, kv_mul: int) -> bool:
    """The reference package's gate for its paged window kernel: the decode
    kernel's, and ``window_supported``."""
    return paged_decode_supported(head_dim, page_size, dtype) and window_supported(s, kv_mul)


def _cache_scores(q_rows, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool):
    """Scores of q_rows [B, n_kv, R, hd] (pre-scaled) over each request's
    valid rows, with V: (scores [B, n_kv, R, T] masked to -inf at t ≥ pos,
    V [B, n_kv, T, hd] with invalid rows zeroed, V scales or None)."""
    page = k_pool.shape[3]
    pos_l = pos.to(device="cpu", dtype=torch.int64)
    n_pages = -(-int(pos_l.max()) // page)
    table = page_table.to(k_pool.device)

    def live(pool):  # the pages below the largest position, every request's
        return gather_pages(pool[layer], table, 0, n_pages)

    kc, vc = live(k_pool).float(), live(v_pool).float()
    sc = torch.einsum("bnrh,bnth->bnrt", q_rows, kc)
    if k_scale_pool is not None:
        sc = sc * live(k_scale_pool)[:, :, None, :]
    t = kc.shape[2]
    valid = (torch.arange(t)[None, :] < pos_l[:, None]).to(q_rows.device)  # [B, T]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    vc = vc.masked_fill(~valid[:, None, :, None], 0.0)  # rows >= pos take no part
    vs = None if v_scale_pool is None else live(v_scale_pool)
    return sc, vc, vs


def paged_decode_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: one softmax over [self, cache rows < pos]."""
    b, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    kv_mul = n_heads // n_kv
    qs = (q.float() * (1.0 / hd**0.5)).reshape(b, n_kv, kv_mul, hd)
    s_self = torch.einsum("bnmh,bnh->bnm", qs, k_new.float())[..., None]
    sc, vc, vs = _cache_scores(qs, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    scores = torch.cat([s_self, sc], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    pc = e[..., 1:]
    if vs is not None:
        pc = pc * vs[:, :, None, :]
    out = e[..., :1] * v_new.float()[:, :, None, :] + torch.einsum("bnmt,bnth->bnmh", pc, vc)
    return (out / denom).reshape(b, n_heads, hd)


def _window_rows(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B, S, n_heads, hd] → the kernel's rows [B, n_kv, R = (mul, s), hd]
    f32, the row order of the reference (``paged_attention.py:465-468``)."""
    b, s, n_heads, hd = q.shape
    qf = q.float().reshape(b, s, n_kv, n_heads // n_kv, hd)
    return qf.permute(0, 2, 3, 1, 4).reshape(b, n_kv, (n_heads // n_kv) * s, hd)


def paged_window_partials_plain(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one softmax over the cache rows < pos →
    (m, l [B, n_kv, R], acc [B, n_kv, R, hd]) f32; m = -inf, l = 0 and acc = 0
    where pos is 0."""
    hd = q.shape[-1]
    rows = _window_rows(q, k_pool.shape[2]) * (1.0 / hd**0.5)
    sc, vc, vs = _cache_scores(rows, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    m = sc.amax(dim=-1) if sc.shape[-1] else torch.full(rows.shape[:3], float("-inf"), device=rows.device)
    finite = torch.isfinite(m)[..., None]
    p = torch.where(finite, torch.exp(sc - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * vs[:, :, None, :]
    return m, l, torch.einsum("bnrt,bnth->bnrh", p, vc)


def decode_qm(kv_mul: int, hd: int = 128) -> int:
    """Query heads a block of the decode kernels takes: at head_dim 128 and
    256 the largest power of two that divides kv_mul, at most 8; past 256
    the largest divisor of kv_mul up to 8 (the heads padded to 8 on
    ``mma.sync``), so that the kernel past 256 reads each K/V row of a kv
    head once wherever kv_mul ≤ 8."""
    if hd > 256:
        return max(d for d in range(1, 9) if kv_mul % d == 0)
    return min(kv_mul & -kv_mul, 8)


def decode_grid(b: int, n_kv: int, kv_mul: int, sms: int, blocks_per_sm: int, hd: int = 128) -> int:
    """Blocks of one launch of the one-launch decode kernel: as many as the
    card holds at once, and at least one per (request, kv head, head tile)."""
    return max(sms * blocks_per_sm, b * n_kv * (kv_mul // decode_qm(kv_mul, hd)))


def decode_plan(pos: list[int], n_kv: int, kv_mul: int, page: int, max_pages: int, grid: int,
                hd: int = 128) -> tuple[int, list[int]]:
    """The one-launch kernel's plan from the positions: (span, splits per
    request), as every block of a launch of ``grid`` blocks makes it.  A request's live rows
    ``min(pos, max_pages·page)`` are cut into splits of ``span`` rows (one
    split when it has none); span is the least multiple of ``SPLIT_ROWS``
    for which the splits of every request, kv head and head tile fit the
    grid."""
    return _plan(pos, n_kv * (kv_mul // decode_qm(kv_mul, hd)), page, max_pages, grid)


def _plan(pos: list[int], per: int, page: int, max_pages: int, grid: int,
          min_span: int = SPLIT_ROWS) -> tuple[int, list[int]]:
    """``decode_plan`` with ``per`` tiles a request (kv heads times head or
    row tiles) and a span of at least ``min_span`` rows (or the longest
    request's, rounded up to ``SPLIT_ROWS``)."""
    live = [min(max(p, 0), max_pages * page) for p in pos]

    def splits(span):
        return [max(1, -(-p // span)) for p in live]

    hi = max(1, -(-max(live, default=0) // SPLIT_ROWS))
    lo = min(min_span // SPLIT_ROWS, hi)
    while lo < hi:
        mid = (lo + hi) // 2
        if sum(splits(mid * SPLIT_ROWS)) * per <= grid:
            hi = mid
        else:
            lo = mid + 1
    return lo * SPLIT_ROWS, splits(lo * SPLIT_ROWS)


def decode_units(pos: list[int], n_kv: int, kv_mul: int, page: int, max_pages: int, grid: int,
                 hd: int = 128) -> list[tuple]:
    """The units of ``decode_plan``, block u taking the u-th: (b, kv head,
    head tile, split, splits, first row, end row, workspace slot of split 0,
    arrival counter), in (request, kv head, head tile, split) order."""
    return _units(pos, n_kv, kv_mul // decode_qm(kv_mul, hd), page, max_pages, grid)


def _units(pos: list[int], n_kv: int, tiles: int, page: int, max_pages: int, grid: int,
           min_span: int = SPLIT_ROWS) -> list[tuple]:
    """``decode_units`` with ``tiles`` tiles a kv head and splits of at least
    ``min_span`` rows."""
    span, splits = _plan(pos, n_kv * tiles, page, max_pages, grid, min_span)
    units = []
    for b, (p, n_s) in enumerate(zip(pos, splits)):
        live = min(max(p, 0), max_pages * page)
        for pair in range(n_kv * tiles):
            for s in range(n_s):
                units.append((b, pair // tiles, pair % tiles, s, n_s, s * span, min(live, (s + 1) * span),
                              len(units) - s, b * n_kv * tiles + pair))
    return units


def decode_workspace_floats(grid: int, kv_mul: int, hd: int) -> tuple[int, int]:
    """Floats of the one-launch kernel's two workspaces: (m, l) and acc of
    one split partial a block."""
    qm = decode_qm(kv_mul, hd)
    return grid * qm * 2, grid * qm * hd


def split_kernel_takes(hd: int, page: int) -> bool:
    """Whether ``paged_decode`` launches the one-launch kernel for a pool of
    head_dim ``hd`` and pages of ``page`` rows (else the two-pass kernels):
    every multiple of 128 up to ``WIDE_MAX_HEAD_DIM`` (past 256 the kernel
    past 256), pages of a multiple of ``SPLIT_ROWS``."""
    return takes_head_dim(hd) and hd <= WIDE_MAX_HEAD_DIM and page % SPLIT_ROWS == 0


def decode_wide_layout(dtype, hd: int) -> dict:
    """The decode kernel's shared memory past head_dim 256 (``dec_wide`` in
    csrc/paged_decode.cu) for a pool of ``dtype`` at head_dim ``hd``: cache
    rows a stage (``WIDE_ROWS``), consumer warps (one a 128 columns), ring
    slots (each a stage's K or V: 16 rows of the head), a slot's bytes, and
    the block's bytes: a 1 KB head (barriers, the unit, q·k_self), the
    stages' partial scores (two buffers of 128 floats a warp), for f32 each
    warp's P (16 × 8 floats) and q (8 heads × hd), for INT8 the slots' row
    scales (``WIDE_MAX_SLOTS`` × 16 floats), 1 KB of alignment, and as many
    slots as keep the block within ``WIDE_BLOCK_BYTES`` (2 to
    ``WIDE_MAX_SLOTS``)."""
    if not (takes_head_dim(hd) and 256 < hd <= WIDE_MAX_HEAD_DIM):
        raise ValueError(f"decode_wide_layout: head_dim {hd}")
    esz = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    warps, slot = hd // 128, WIDE_ROWS * hd * esz
    ring = 1024 + 2 * warps * 128 * 4
    ring += warps * WIDE_ROWS * 8 * 4 + 8 * hd * 4 if esz == 4 else WIDE_MAX_SLOTS * WIDE_ROWS * 4 if esz == 1 else 0
    slots = min(WIDE_MAX_SLOTS, max(2, (WIDE_BLOCK_BYTES - ring - 1024) // slot))
    return {"rows": WIDE_ROWS, "warps": warps, "slots": slots, "slot_bytes": slot,
            "smem": ring + 1024 + slots * slot}


def window_split_takes(hd: int, page: int, dtype) -> bool:
    """Whether ``paged_window_partials`` launches the one-launch window
    kernel (else the two-pass kernels): every head_dim the kernels take
    (past 256 in column slices: ``window_slices``), pages of a multiple of
    ``SPLIT_ROWS``, every pool type (an f32 pool's rows, not exact in bf16,
    go to the tensor cores as bf16 hi and lo, each product in three
    terms)."""
    return takes_head_dim(hd) and page % SPLIT_ROWS == 0 and dtype in _CACHE_TYPES


def window_slices(hd: int) -> int:
    """Column slices of the window kernel at head_dim ``hd``: one up to
    256, else ``ceil(hd / WINDOW_WIDE_COLS)`` (the last one 128 wide where
    256 does not divide hd), each a block's share of the output."""
    return 1 if hd <= 256 else -(-hd // WINDOW_WIDE_COLS)


def window_q_scratch_bytes(grid: int, hd: int) -> int:
    """Bytes of the window kernel's q scratch past head_dim 256: each
    block's 64 query rows by hd in two bf16 terms (none up to 256)."""
    return 0 if hd <= 256 else grid * WINDOW_ROW_TILE * hd * 4


def window_wide_layout(dtype) -> dict:
    """The window kernel's shared memory past head_dim 256 for a pool of
    ``dtype`` (``WideSmem`` in csrc/paged_decode.cu): cache rows a stage (64;
    f32 32), ring slots (as many as fit: a band of q's two terms, 16 KB,
    beside the stage's raw K band of 64 columns and, for INT8 and f32, its
    bf16 terms), V stages (the slice's 256 raw columns; INT8: then the K and
    V row scales, rounded to 1 KB), and the block's bytes (a 256-byte head,
    1 KB of alignment, and the converted V stage of INT8 and f32)."""
    esz = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[dtype]
    rows = 32 if esz == 4 else 64
    terms = {4: 2, 2: 0, 1: 1}[esz]
    raw_band = rows * 64 * esz
    slot = 2 * WINDOW_ROW_TILE * 128 + raw_band + terms * rows * 128
    slots = {4: 4, 2: 6, 1: 5}[esz]
    vstage = -(-(WINDOW_WIDE_COLS // 64 * raw_band + (2 * rows * 4 if esz == 1 else 0)) // 1024) * 1024
    conv_v = terms * WINDOW_WIDE_COLS // 64 * rows * 128
    return {"rows": rows, "slots": slots, "slot_bytes": slot, "vstages": 2, "vstage_bytes": vstage,
            "smem": 256 + 1024 + slots * slot + 2 * vstage + conv_v}


def window_tiles(r: int) -> int:
    """Row tiles of ``WINDOW_ROW_TILE`` query rows over a kv head's ``r``
    rows."""
    return -(-r // WINDOW_ROW_TILE)


def window_grid(b: int, n_kv: int, r: int, sms: int, blocks_per_sm: int, hd: int = 128) -> int:
    """Blocks of one launch of the window kernel: as many as the card holds
    at once, and at least one per (request, kv head, row tile, column
    slice); past 256, two waves where those units fill more than half of
    one (one wave would then leave the plan no room to cut a long request
    into splits: at the 8B's heads the 4064-row request was one block's
    64 stages; where they fill less, a second wave cost each block its q
    conversion again and ran slower)."""
    units = b * n_kv * window_tiles(r) * window_slices(hd)
    wave = sms * blocks_per_sm
    return max(2 * wave if hd > 256 and 2 * units > wave else wave, units)


def window_units(pos: list[int], n_kv: int, r: int, page: int, max_pages: int, grid: int,
                 hd: int = 128) -> list[tuple]:
    """The window kernel's units, block u taking the u-th: ``decode_units``'
    plan and layout with the row tiles of ``r`` query rows times the column
    slices of head_dim ``hd`` in place of head tiles (tile t is row tile
    ``t // window_slices(hd)``, slice ``t % window_slices(hd)``) and splits
    of at least ``WINDOW_MIN_SPAN`` rows (a split's partial is a tile of rows
    by hd: a shorter split costs its block's fixed start and its partial's
    write and merge more than it saves): (b, kv head, tile, split, splits,
    first row, end row, workspace slot of split 0, arrival counter)."""
    return _units(pos, n_kv, window_tiles(r) * window_slices(hd), page, max_pages, grid, WINDOW_MIN_SPAN)


def window_workspace_floats(grid: int, hd: int) -> tuple[int, int]:
    """Floats of the window kernel's two workspaces: (m, l) and acc of one
    split partial of a row tile a block."""
    return grid * WINDOW_ROW_TILE * 2, grid * WINDOW_ROW_TILE * hd


def bf16_terms(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """x (f32) as ``n`` bf16 terms, each the nearest bf16 to what the terms
    before it leave, as the tensor-core stages split q and P
    (``split_terms`` in ``csrc/paged_decode.cu``): two hold x to ~2^-17 of
    its value, three to every bit of an f32."""
    terms, rest = [], x.float()
    for _ in range(n):
        terms.append(rest.to(torch.bfloat16))
        rest = rest - terms[-1].float()
    return terms


_DECODE_COUNTERS: dict = {}


def _decode_counters(dev: torch.device, n: int) -> torch.Tensor:
    """The one-launch kernel's arrival counters on ``dev``: one zero int per
    (request, kv head, head tile), made once (grown when a launch needs more);
    each launch leaves them zero."""
    t = _DECODE_COUNTERS.get(dev)
    if t is None or t.numel() < n:
        t = _DECODE_COUNTERS[dev] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return t


@functools.cache
def _blocks_per_sm(index: int, cache_type: int, hd: int, qm: int) -> int:
    with torch.cuda.device(index):
        n = _split_lib().paged_decode_blocks_per_sm(cache_type, hd, qm)
    if n < 1:
        raise RuntimeError(f"paged_decode: no kernel instance for pool type {cache_type}, head_dim {hd}, "
                           f"{qm} heads a block")
    return n


def split_grid(dev: torch.device, pool_dtype: torch.dtype, hd: int, b: int, n_kv: int, kv_mul: int,
               dense: bool = False) -> int:
    """Blocks of a one-launch #9 call on ``dev`` (``decode_grid`` with the
    card's SMs and the instance's blocks an SM); ``dense``: #4's call on a
    dense layer."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return decode_grid(b, n_kv, kv_mul, _sm_count(index),
                       _blocks_per_sm(index, _cache_type(pool_dtype, dense), hd, decode_qm(kv_mul, hd)), hd)


def _cache_type(dtype: torch.dtype, dense: bool) -> int:
    """The one-launch decode kernel's cache type: an INT8 dense layer (#4,
    held to 1e-5) splits q and P into three bf16 terms, an INT8 pool (#9,
    held to 1e-4·max|ref|) into two, which were faster there on the card."""
    return _EXACT_INT8 if dense and dtype == torch.int8 else _CACHE_TYPES[dtype]


def paged_decode_kernel_plan(pos: torch.Tensor, n_kv: int, kv_mul: int, page: int, max_pages: int,
                             grid: int, hd: int = 128) -> list[tuple]:
    """The plan the one-launch kernel's blocks make from ``pos`` (int32 [B]
    on the card) in a launch of ``grid`` blocks at head_dim ``hd``, read
    back: the units of the blocks that took one, in block order, as
    ``decode_units`` gives them (card only; a block past the last unit must
    take none)."""
    return _kernel_plan("paged_decode_plan", pos, grid, lambda lib, units, stream: lib.paged_decode_plan(
        pos.data_ptr(), pos.shape[0], n_kv, kv_mul, decode_qm(kv_mul, hd), page, max_pages, grid, units, stream))


def paged_window_kernel_plan(pos: torch.Tensor, n_kv: int, r: int, page: int, max_pages: int,
                             grid: int, hd: int = 128) -> list[tuple]:
    """The plan the window kernel's blocks make from ``pos`` for ``r`` query
    rows a kv head at head_dim ``hd`` in a launch of ``grid`` blocks, read
    back as ``window_units`` gives it (card only)."""
    return _kernel_plan("paged_window_plan", pos, grid, lambda lib, units, stream: lib.paged_window_plan(
        pos.data_ptr(), pos.shape[0], n_kv, r, hd, page, max_pages, grid, units, stream))


def decode_wide_kernel_layout(dtype, hd: int) -> dict:
    """``decode_wide_layout`` as the kernel's source makes it (card only:
    the built library's ``paged_decode_wide_layout``)."""
    out = (ctypes.c_int * 5)()
    build.check(_split_lib().paged_decode_wide_layout(_CACHE_TYPES[dtype], hd, out), "paged_decode_wide_layout")
    return dict(zip(("rows", "warps", "slots", "slot_bytes", "smem"), list(out)))


def window_wide_kernel_layout(dtype) -> dict:
    """``window_wide_layout`` as the kernel's source makes it (card only:
    the built library's ``paged_window_wide_layout``)."""
    out = (ctypes.c_int * 6)()
    build.check(_split_lib().paged_window_wide_layout(_CACHE_TYPES[dtype], out), "paged_window_wide_layout")
    return dict(zip(("rows", "slots", "slot_bytes", "vstages", "vstage_bytes", "smem"), list(out)))


def _kernel_plan(name: str, pos: torch.Tensor, grid: int, call) -> list[tuple]:
    if pos.device.type != "cuda" or pos.dtype != torch.int32 or pos.dim() != 1 or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be contiguous int32 [B] on the card")
    units = torch.full((grid, 10), -1, dtype=torch.int32, device=pos.device)
    build.check(call(_split_lib(), units.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream), name)
    rows = units.cpu().tolist()
    taken = [tuple(r[1:]) for r in rows if r[0] == 1]
    if any(r[0] != 1 for r in rows[:len(taken)]) or any(r[0] != 0 for r in rows[len(taken):]):
        raise RuntimeError(f"{name}: the blocks with units are not the first ones")
    return taken


@functools.cache
def _window_blocks_per_sm(index: int, cache_type: int, hd: int) -> int:
    with torch.cuda.device(index):
        n = _split_lib().paged_window_blocks_per_sm(cache_type, hd)
    if n < 1:
        raise RuntimeError(f"paged_window_partials: no kernel instance for pool type {cache_type}, head_dim {hd}")
    return n


def window_split_grid(dev: torch.device, pool_dtype: torch.dtype, hd: int, b: int, n_kv: int, r: int) -> int:
    """Blocks of a one-launch #10 call on ``dev`` (``window_grid`` with the
    card's SMs and the instance's blocks an SM)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return window_grid(b, n_kv, r, _sm_count(index), _window_blocks_per_sm(index, _CACHE_TYPES[pool_dtype], hd), hd)


@functools.cache
def _split_lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode_blocks_per_sm.argtypes = [i, i, i]
    lib.paged_decode_blocks_per_sm.restype = ctypes.c_int
    lib.paged_decode_split.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, p, p, p, p, p, p]
    lib.paged_decode_split.restype = ctypes.c_int
    lib.paged_decode_plan.argtypes = [p, i, i, i, i, i, i, i, p, p]
    lib.paged_decode_plan.restype = ctypes.c_int
    lib.paged_window_blocks_per_sm.argtypes = [i, i]
    lib.paged_window_blocks_per_sm.restype = ctypes.c_int
    lib.paged_window_split.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, p, p, p, p, p, p, p, p, p]
    lib.paged_window_split.restype = ctypes.c_int
    lib.paged_window_plan.argtypes = [p, i, i, i, i, i, i, i, p, p]
    lib.paged_window_plan.restype = ctypes.c_int
    lib.paged_window_wide_layout.argtypes = [i, p]
    lib.paged_window_wide_layout.restype = ctypes.c_int
    lib.paged_decode_wide_layout.argtypes = [i, i, p]
    lib.paged_decode_wide_layout.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_decode.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p, p, p, p]
    lib.paged_decode.restype = ctypes.c_int
    lib.paged_window_partials.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p, p, p, p, p, p]
    lib.paged_window_partials.restype = ctypes.c_int
    return lib


def _check_pool(name, q, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool):
    """Device, type, shape and contiguity checks shared by both kernels."""

    def need(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{name}: {msg}")

    need(q.device.type == "cuda", f"tensors on {q.device} are neither CPU nor CUDA")
    n_layers, _, n_kv, page, hd = k_pool.shape
    need(takes_head_dim(hd) and q.shape[-1] == hd, f"head_dim {hd} (the kernels take positive multiples of 128)")
    need(q.shape[-2] % n_kv == 0, f"{q.shape[-2]} query heads over {n_kv} kv heads")
    need(0 <= layer < n_layers, f"layer {layer} out of range")
    need(v_pool.shape == k_pool.shape and v_pool.dtype == k_pool.dtype, "k_pool and v_pool differ")
    need(k_pool.dtype in _CACHE_TYPES, f"pool dtype {k_pool.dtype} is not f32/bf16/int8")
    need(k_pool.is_contiguous() and v_pool.is_contiguous(), "the pool must be contiguous")
    quant = k_pool.dtype == torch.int8
    need(quant == (k_scale_pool is not None) == (v_scale_pool is not None), "an INT8 pool needs both scales")
    tensors = [k_pool, v_pool, page_table, pos]
    if quant:
        for s in (k_scale_pool, v_scale_pool):
            need(s.shape == k_pool.shape[:-1] and s.dtype == torch.float32 and s.is_contiguous(),
                 "scales must be contiguous f32 [L, P, n_kv, page]")
        tensors += [k_scale_pool, v_scale_pool]
    b = q.shape[0]
    need(page_table.dtype == torch.int32 and page_table.dim() == 2 and page_table.shape[0] == b
         and page_table.is_contiguous(), "page_table must be contiguous int32 [B, max_pages]")
    need(pos.dtype == torch.int32 and pos.shape == (b,), "pos must be int32 [B]")
    need(all(t.device == q.device for t in tensors), "all tensors must be on one device")
    lp = k_pool[0].numel()  # elements of one layer's pool
    ptrs = [k_pool.data_ptr() + layer * lp * k_pool.element_size(),
            v_pool.data_ptr() + layer * lp * v_pool.element_size()]
    ptrs += ([k_scale_pool.data_ptr() + layer * (lp // hd) * 4, v_scale_pool.data_ptr() + layer * (lp // hd) * 4]
             if quant else [None, None])
    return ptrs, n_kv, page, page_table.shape[1]


def paged_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention of layer ``layer`` over the pool → ``[B, n_heads, hd]`` f32.

    q ``[B, n_heads, hd]``, k_new/v_new ``[B, n_kv, hd]``, pools
    ``[L, P, n_kv, page, hd]``, page_table ``[B, max_pages]``, pos ``[B]``
    (on the card: int32 tensors on the same device, pos at most
    max_pages·page).
    """
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_new, v_new, k_pool, v_pool, page_table, pos, layer,
                                  k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    (k, v, ks, vs), n_kv, page, max_pages = _check_pool(
        "paged_decode", q, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    b, n_heads, hd = q.shape
    kv_mul = n_heads // n_kv
    qf = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    if kn.shape != (b, n_kv, hd) or vn.shape != kn.shape:
        raise ValueError("paged_decode: k_new/v_new must be [B, n_kv, hd]")
    out = torch.empty(b, n_heads, hd, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if split_kernel_takes(hd, page):
        one_launch(qf, kn, vn, k_pool, (k, v, ks, vs), page_table, pos, kv_mul, out, None)
        return out
    n_chunks = -(-max_pages * page // CHUNK)
    slots = b * n_kv * n_chunks * kv_mul
    part_ml = torch.empty(slots * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(slots * hd, dtype=torch.float32, device=q.device)
    err = _lib().paged_decode(
        qf.data_ptr(), kn.data_ptr(), vn.data_ptr(), k, v, ks, vs,
        page_table.data_ptr(), pos.data_ptr(), _CACHE_TYPES[k_pool.dtype],
        b, n_kv, kv_mul, page, max_pages, hd, 1.0 / hd**0.5,
        part_ml.data_ptr(), part_acc.data_ptr(), out.data_ptr(), stream,
    )
    build.check(err, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


def one_launch(qf, kn, vn, k_pool, ptrs, page_table, pos, kv_mul, out, stamps, key="paged_decode") -> int:
    """One launch of the one-launch decode kernel (checked inputs: q, k_new,
    v_new f32 contiguous; ptrs the layer's pool and scale pointers) into
    ``out``, counted under ``LAUNCHES[key]``; ``page_table`` None for a
    dense layer ``[B, n_kv, T, hd]`` viewed as B pages of T rows (request b's
    page is b); ``stamps`` an int64 tensor of ``[grid, 8]`` or None.
    Returns the grid."""
    k, v, ks, vs = ptrs
    b, n_kv, hd = kn.shape
    page, max_pages = k_pool.shape[3], 1 if page_table is None else page_table.shape[1]
    qm = decode_qm(kv_mul, hd)
    grid = split_grid(qf.device, k_pool.dtype, hd, b, n_kv, kv_mul, page_table is None)
    if stamps is not None and stamps.shape != (grid, 8):
        raise ValueError(f"paged_decode: stamps must be [{grid}, 8]")
    n_ml, n_acc = decode_workspace_floats(grid, kv_mul, hd)
    ws = torch.empty(n_acc + n_ml, dtype=torch.float32, device=qf.device)  # acc first: 16-byte rows
    counters = _decode_counters(qf.device, b * n_kv * (kv_mul // qm))
    err = _split_lib().paged_decode_split(
        qf.data_ptr(), kn.data_ptr(), vn.data_ptr(), k, v, ks, vs,
        None if page_table is None else page_table.data_ptr(), pos.data_ptr(),
        _cache_type(k_pool.dtype, page_table is None), b, n_kv, kv_mul, qm, k_pool.shape[1], page, max_pages, hd,
        1.0 / hd**0.5,
        grid, ws.data_ptr() + n_acc * 4, ws.data_ptr(), counters.data_ptr(), out.data_ptr(),
        None if stamps is None else stamps.data_ptr(), torch.cuda.current_stream(qf.device).cuda_stream,
    )
    build.check(err, key)
    LAUNCHES[key] += 1
    return grid


def launch_phases(qf, kn, vn, k_pool, ptrs, page_table, pos, kv_mul) -> dict:
    """``paged_decode_phases``' breakdown of one launch on checked inputs
    (``one_launch``'s arguments), after one launch unstamped."""
    out = torch.empty(qf.shape, dtype=torch.float32, device=qf.device)
    grid = one_launch(qf, kn, vn, k_pool, ptrs, page_table, pos, kv_mul, out, None)
    stamps = torch.zeros(grid, 8, dtype=torch.int64, device=qf.device)
    one_launch(qf, kn, vn, k_pool, ptrs, page_table, pos, kv_mul, out, stamps)
    return stamp_phases(stamps.cpu().tolist())


def paged_decode_phases(q, k_new, v_new, k_pool, v_pool, page_table, pos, layer, *,
                        k_scale_pool=None, v_scale_pool=None) -> dict:
    """Where one launch of the one-launch decode kernel spends its time (card
    only): median µs over the blocks with rows of each phase, from the
    kernel's own clock stamps (``plan``: start to the plan made; ``first_copy``
    and ``first_stage``: from the plan to the producer's first copies issued
    and to the first stage landed; ``stages``: the first stage landed to the
    last done; ``partial``: the partial written; ``arrive``: the arrival
    counted; ``merge``: the last blocks' merge), and the launch's span."""
    (k, v, ks, vs), n_kv, page, max_pages = _check_pool(
        "paged_decode_phases", q, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    if not split_kernel_takes(q.shape[-1], page):
        raise ValueError("paged_decode_phases: the pool takes the two-pass kernels")
    return launch_phases(q.float().contiguous(), k_new.float().contiguous(), v_new.float().contiguous(), k_pool,
                         (k, v, ks, vs), page_table, pos, q.shape[1] // n_kv)


def stamp_phases(stamps: list[list[int]]) -> dict:
    """The phase breakdown of ``paged_decode_phases`` from a launch's stamps
    (a row of 8 global-timer ns a block; 0 where a block took no such step)."""
    active = [r for r in stamps if r[1] and r[4]]
    t0 = min(r[0] for r in stamps)

    def med(i, j):
        d = [(r[j] - r[i]) / 1e3 for r in active if r[i] and r[j]]
        return statistics.median(d) if d else None

    return {"blocks": len(stamps), "blocks_with_rows": len(active), "plan": med(0, 1), "first_copy": med(1, 2),
            "first_stage": med(1, 3), "stages": med(3, 4), "partial": med(4, 5), "arrive": med(5, 6),
            "merge": med(6, 7), "span": (max(max(r) for r in stamps) - t0) / 1e3}


def paged_window_partials(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cache-part partials of a window q ``[B, S, n_heads, hd]`` over layer
    ``layer`` of the pool → (m, l ``[B, n_kv, R]``, acc ``[B, n_kv, R, hd]``)
    f32, with R = S·kv_mul rows in the order (mul, s).  On the card: one
    launch of the window kernel where ``window_split_takes``, else the
    two-pass kernels."""
    if q.device.type == "cpu":
        return paged_window_partials_plain(q, k_pool, v_pool, page_table, pos, layer,
                                           k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    (k, v, ks, vs), n_kv, page, max_pages = _check_pool(
        "paged_window_partials", q, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    b, s, n_heads, hd = q.shape
    r = s * (n_heads // n_kv)
    if r > MAX_WINDOW_ROWS:
        raise ValueError(f"paged_window_partials: S·kv_mul = {r} > {MAX_WINDOW_ROWS}")
    m = torch.empty(b, n_kv, r, dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty(b, n_kv, r, hd, dtype=torch.float32, device=q.device)
    if window_split_takes(hd, page, k_pool.dtype):
        _window_launch(q.float().contiguous(), k_pool, (k, v, ks, vs), page_table, pos, (m, l, acc), None)
        return m, l, acc
    rows = _window_rows(q, n_kv).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_chunks = -(-max_pages * page // CHUNK)
    slots = b * n_kv * n_chunks * r
    part_ml = torch.empty(slots * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(slots * hd, dtype=torch.float32, device=q.device)
    err = _lib().paged_window_partials(
        rows.data_ptr(), k, v, ks, vs, page_table.data_ptr(), pos.data_ptr(),
        _CACHE_TYPES[k_pool.dtype], b, n_kv, r, page, max_pages, hd, 1.0 / hd**0.5,
        part_ml.data_ptr(), part_acc.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(), stream,
    )
    build.check(err, "paged_window_partials")
    LAUNCHES["paged_window_partials"] += 1
    return m, l, acc


def _window_launch(q, k_pool, ptrs, page_table, pos, outs, stamps) -> int:
    """One launch of the window kernel (checked inputs: q ``[B, S, n_heads,
    hd]`` f32 contiguous, read in the rows' (mul, s) order by the kernel;
    ptrs the layer's pool and scale pointers) into ``outs`` (m, l, acc),
    counted under ``paged_window_partials``; ``stamps`` an int64 tensor of
    ``[grid, 8]`` or None.  Returns the grid."""
    k, v, ks, vs = ptrs
    b, s, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    kv_mul = n_heads // n_kv
    r = s * kv_mul
    grid = window_split_grid(q.device, k_pool.dtype, hd, b, n_kv, r)
    if stamps is not None and stamps.shape != (grid, 8):
        raise ValueError(f"paged_window_partials: stamps must be [{grid}, 8]")
    n_ml, n_acc = window_workspace_floats(grid, hd)
    n_q = window_q_scratch_bytes(grid, hd) // 4
    ws = torch.empty(n_acc + n_q + n_ml, dtype=torch.float32, device=q.device)  # acc, q terms: 16-byte rows
    counters = _decode_counters(q.device, b * n_kv * window_tiles(r) * window_slices(hd))
    m, l, acc = outs
    err = _split_lib().paged_window_split(
        q.data_ptr(), k, v, ks, vs, page_table.data_ptr(), pos.data_ptr(), _CACHE_TYPES[k_pool.dtype],
        b, n_kv, s, kv_mul, k_pool.shape[1], k_pool.shape[3], page_table.shape[1], hd, 1.0 / hd**0.5, grid,
        ws.data_ptr() + (n_acc + n_q) * 4, ws.data_ptr(), ws.data_ptr() + n_acc * 4 if n_q else None,
        counters.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        None if stamps is None else stamps.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_window_partials")
    LAUNCHES["paged_window_partials"] += 1
    return grid


def paged_window_phases(q, k_pool, v_pool, page_table, pos, layer, *, k_scale_pool=None, v_scale_pool=None) -> dict:
    """Where one launch of the window kernel spends its time (card only):
    ``paged_decode_phases``' breakdown from the kernel's clock stamps, after
    one launch unstamped (past head_dim 256 ``first_stage`` ends when the
    warpgroup starts its stages, q converted, and ``stages`` runs from
    there)."""
    ptrs, n_kv, page, _ = _check_pool(
        "paged_window_phases", q, k_pool, v_pool, page_table, pos, layer, k_scale_pool, v_scale_pool)
    if not window_split_takes(q.shape[-1], page, k_pool.dtype):
        raise ValueError("paged_window_phases: the pool takes the two-pass kernels")
    qf = q.float().contiguous()
    b, s, n_heads, hd = qf.shape
    r = s * (n_heads // n_kv)
    outs = (torch.empty(b, n_kv, r, device=q.device), torch.empty(b, n_kv, r, device=q.device),
            torch.empty(b, n_kv, r, hd, device=q.device))
    grid = _window_launch(qf, k_pool, ptrs, page_table, pos, outs, None)
    stamps = torch.zeros(grid, 8, dtype=torch.int64, device=q.device)
    _window_launch(qf, k_pool, ptrs, page_table, pos, outs, stamps)
    return stamp_phases(stamps.cpu().tolist())


def paged_window_attention(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_pool: torch.Tensor | None = None,
    v_scale_pool: torch.Tensor | None = None,
    fresh: bool = False,
) -> torch.Tensor:
    """Window attention of layer ``layer``: q ``[B, S, n_heads, hd]`` at
    positions pos[b] + i over the pool's rows < pos plus the window's own
    K/V (``[B, S, n_kv, hd]``, causal) → ``[B, S, n_heads, hd]`` f32.  The
    cache part is ``paged_window_partials``; the merge is plain PyTorch.
    A ``fresh`` window (every pos 0) has an empty cache part, so no kernel
    runs: its partials are the ones the kernel gives at pos 0."""
    b, s, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    kv_mul = n_heads // n_kv
    if fresh:
        m = torch.full((b, n_kv, kv_mul * s), float("-inf"), device=q.device)
        l, acc = torch.zeros_like(m), torch.zeros(b, n_kv, kv_mul * s, hd, device=q.device)
    else:
        m, l, acc = paged_window_partials(q, k_pool, v_pool, page_table, pos, layer,
                                          k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    qf = q.float().reshape(b, s, n_kv, kv_mul, hd)
    out = _merge_window(  # [B, KV, M, S, hd]
        qf, m.reshape(b, n_kv, kv_mul, s, 1), l.reshape(b, n_kv, kv_mul, s, 1),
        acc.reshape(b, n_kv, kv_mul, s, hd), k_new, v_new, 0,
    )
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, n_heads, hd)
