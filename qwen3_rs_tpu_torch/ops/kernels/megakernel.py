"""Whole-step decode megakernel: the Hopper kernel, its plain version and its
shape gate.

``decode_stack_megakernel`` runs one whole decode step of B ≤ 8 rows over the
dense cache: every layer (RMSNorm, wqkv, QK-norm and RoPE, attention over the
cache rows below each row's position seeded with the step's own key, the
step's K/V row written in place, wo and the residual, RMSNorm, w13, SwiGLU, w2
and the residual) and, optionally, the final RMSNorm and the classifier, or
its first-max argmax.  It replaces the reference package's
``decode_stack_megakernel`` (``ops/pallas/megakernel.py``).

Numerics, as the reference kernel's (which differ from the per-layer path):
the residual stream is f32; each matmul rounds its activation to bf16 at the
dot, each weight element is ``bf16(bf16(code) · bf16(scale))``, sums are f32;
attention is f32 with q scaled by ``1/√128`` after RoPE, over the rows below
``min(pos, T)``; the K/V row goes to ``min(pos, T - 1)`` in the cache's dtype
where ``write_ok`` (INT8: scale ``amax/127``, codes rounded half to even),
after every read of its layer.

INT4 checkpoints: the four layer matrices may be ``Q4Tensor`` stacks
(nibble-packed codes ``[L, N/2, D]``, bf16 scales), the classifier staying
INT8; each weight element is then ``bf16(code · bf16(scale))`` of the
unpacked code, as the reference's Q4 tiles (``_dequant_tile_q4``) compute it.
Such a launch counts under ``LAUNCHES["decode_megakernel_q4"]``.

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it makes one cooperative launch of ``csrc/decode_megakernel.cu`` or
raises.  ``megakernel_supported`` and ``head_phase_supported`` are the
reference package's gates, with its default budgets, so that the port takes
the kernel on exactly the shapes the reference takes it.  The gate reads one
environment variable, as the reference's does: ``QWEN3_TPU_MEGA_Q4=1``
admits INT4 layers (the reference's only route to its Q4 tiles; off by
default there and here).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import os

import torch

from ..quant import Q4Tensor
from . import LAUNCHES, build
from .qmatmul import qmatmul_w8a16_plain

CHUNK = 128  # cache rows per attention item of the kernel
HEAD_DIM = 128  # the head_dim the kernel takes, as the reference's gate admits only 128
MAX_BATCH = 8  # rows per step the gate admits (the reference's default)
_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# ------------------------------------------------------------------ the gate
# The reference package's tile plans, kept only to decide where the kernel
# engages: its default code-byte budget per weight tile (2 MB; 6 MB at dim
# 2560, where full-depth tiles are admitted), the classifier phase's budget
# and widest tile, the cache-block candidates and the INT8 scale block.
_BLK_CANDIDATES = (512, 256, 128)
_SCALE_BLK = 128
_HEAD_TD_CAP = 8192


def _pick_blk(t: int) -> int | None:
    for b in _BLK_CANDIDATES:
        if t % b == 0:
            return b
    return None


def _mk_tiles(n: int, d: int, g: int, tile_bytes: int, td_cap: int = 4096,
              full_depth: bool = False, q4: bool = False,
              max_q4_elems: int | None = None) -> tuple[int, int] | None:
    """(tn, td) dividing (n, d): tn a multiple of g with 8-aligned group rows
    (or tn == n) and at most 1024 rows (or n, with ``full_depth``), td a
    multiple of 256 up to ``td_cap`` (or d, 128-aligned); the largest tile
    whose codes fit ``tile_bytes``, then the most tiles.  ``q4``: packed
    codes, tn/2 bytes per column, tn/2 a multiple of 32, and at most
    ``max_q4_elems`` elements a tile (default: ``tile_bytes``)."""
    tn_cands = [c for c in range(g, n + 1, g) if n % c == 0 and ((c // g) % 8 == 0 or c == n) and c <= 1024]
    if not tn_cands and n % g == 0:
        tn_cands = [n]
    if full_depth and n % g == 0 and (n // g) % 8 == 0 and n not in tn_cands:
        tn_cands.append(n)
    if q4:
        tn_cands = [c for c in tn_cands if c % 2 == 0 and (c // 2) % 32 == 0]
    td_cands = [c for c in range(256, d + 1, 256) if d % c == 0 and c <= td_cap]
    if not td_cands and d % 128 == 0:
        td_cands = [d]
    max_q4_elems = max_q4_elems or tile_bytes
    best = None
    for tn in tn_cands:
        for td in td_cands:
            code_bytes = tn * td // 2 if q4 else tn * td
            if code_bytes > tile_bytes or (q4 and tn * td > max_q4_elems):
                continue
            key = (code_bytes, -((n // tn) * (d // td)))
            if best is None or key > best[0]:
                best = (key, tn, td)
    return None if best is None else (best[1], best[2])


def _tile_budget(dim: int) -> int:
    return 6 * 1024 * 1024 if dim == 2560 else 2 * 1024 * 1024


def q4_opted_in() -> bool:
    """``QWEN3_TPU_MEGA_Q4=1``: the reference package's opt-in to its Q4
    tiles (default off there, where they measured slower than the per-matrix
    Q4 kernels on its chip), read as it reads it."""
    return os.environ.get("QWEN3_TPU_MEGA_Q4", "0") == "1"


def megakernel_supported(config, t: int, dtype, batch: int = 1, q4: bool = False) -> bool:
    """Whether a decode step of ``batch`` rows over a dense cache of ``t`` rows
    of ``dtype`` (``torch.float32``, ``torch.bfloat16``, ``torch.int8`` or
    ``"int8"``) takes the megakernel: the reference package's gate.  INT4
    layers (``q4``) take it only with the reference's opt-in
    (``q4_opted_in``), on tiles of packed codes.  The port's kernel takes
    every shape the gate admits."""
    dtype = torch.int8 if dtype == "int8" else dtype
    if dtype not in _CACHE_TYPES or batch > MAX_BATCH:
        return False
    if config.head_dim != HEAD_DIM or config.n_heads % config.n_kv_heads:
        return False
    blk = _pick_blk(t)
    if blk is None or (dtype == torch.int8 and (t % _SCALE_BLK or blk % _SCALE_BLK)):
        return False
    g = config.group_size
    if q4 and (g % 2 or not q4_opted_in()):
        return False
    full_depth = config.dim == 2560
    for n, d in (
        (config.dim, config.all_heads_dim + 2 * config.kv_dim),
        (config.all_heads_dim, config.dim),
        (config.dim, 2 * config.hidden_dim),
        (config.hidden_dim, config.dim),
    ):
        tiles = _mk_tiles(n, d, g, _tile_budget(config.dim), full_depth=full_depth, q4=q4)
        if tiles is None or (tiles[0] // g) % 8:
            return False
    return True


def head_phase_supported(config, v_pad: int) -> bool:
    """Whether the classifier runs as the kernel's last phase (the reference
    package's gate, with its default budget)."""
    budget = 2 * 1024 * 1024 if config.dim <= 2048 else 6 * 1024 * 1024
    tiles = _mk_tiles(config.dim, v_pad, config.group_size, budget, td_cap=_HEAD_TD_CAP,
                      full_depth=config.dim == 2560)
    return tiles is not None and (tiles[0] // config.group_size) % 8 == 0


# ------------------------------------------------------------ plain version
def _layer_attention(q, k_new, v_new, k_all, v_all, k_sc, v_sc, p):
    """f32 attention of one layer: q [B, H, hd] (scaled), the self key and
    value [B, KV, hd], cache rows [B, KV, T, hd] below p [B] (device ints),
    scales [B, KV, T] or None."""
    b, h, hd = q.shape
    n_kv, t = k_all.shape[1], k_all.shape[2]
    qs = q.reshape(b, n_kv, h // n_kv, hd)
    s_self = torch.einsum("bnmh,bnh->bnm", qs, k_new)[..., None]
    sc = torch.einsum("bnmh,bnth->bnmt", qs, k_all.float())
    if k_sc is not None:
        sc = sc * k_sc[:, :, None, :]
    valid = torch.arange(t, device=q.device)[None, :] < p[:, None]  # [B, T]
    sc = torch.where(valid[:, None, None, :], sc, float("-inf"))
    vc = torch.where(valid[:, None, :, None], v_all.float(), 0.0)  # rows >= p take no part
    scores = torch.cat([s_self, sc], dim=-1)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    pc = e[..., 1:]
    if v_sc is not None:
        pc = pc * torch.where(valid[:, None, :], v_sc, 0.0)[:, :, None, :]
    out = e[..., :1] * v_new[:, :, None, :] + torch.einsum("bnmt,bnth->bnmh", pc, vc)
    return (out / denom).reshape(b, h * hd)


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row INT8 over the last axis: scale ``amax/127``."""
    sc = x.abs().amax(dim=-1) / 127.0
    safe = torch.where(sc == 0.0, torch.ones_like(sc), sc)
    return torch.round(x / safe[..., None]).to(torch.int8), sc


def _rms_rows(m, w, eps):
    return m * torch.rsqrt((m * m).mean(dim=-1, keepdim=True) + eps) * w


def _rope(m, cos, sin):
    half = m.shape[-1] // 2
    m1, m2 = m[..., :half], m[..., half:]
    return torch.cat([m1 * cos - m2 * sin, m1 * sin + m2 * cos], dim=-1)


def decode_stack_megakernel_plain(
    config, x, rms_att, rms_ffn, q_norm, k_norm, cos, sin, wqkv, wo, w13, w2, k_cache, v_cache, pos,
    rms_final=None, lm_head=None, write_ok=None, k_scale=None, v_scale=None, *, eps=1e-6,
    greedy=False,
):
    """Plain PyTorch version: the same arguments and results as
    ``decode_stack_megakernel``, up to the f32 summation order.  It reads
    positions and gates on the device (no host synchronisation).  INT4
    layers take the same plain matmul, which unpacks each band of codes
    (``unpack_q4``) and computes ``bf16(code · bf16(scale))``."""
    c = config
    b = x.shape[0]
    t = k_cache.shape[3]
    ah, kvd, hd, n_kv = c.all_heads_dim, c.kv_dim, c.head_dim, c.n_kv_heads
    pos = pos.to(device=x.device, dtype=torch.long).reshape(b)
    p_read = pos.clamp(0, t)
    rows = pos.clamp(0, t - 1)
    ok = torch.ones(b, dtype=torch.bool, device=x.device) if write_ok is None else (
        write_ok.to(device=x.device).reshape(b) != 0)
    bi = torch.arange(b, device=x.device)
    cos_r, sin_r = cos.float()[:, None, :], sin.float()[:, None, :]
    x = x.float()
    for l in range(k_cache.shape[0]):
        qkv = qmatmul_w8a16_plain(x, wqkv, l, norm_w=rms_att, eps=eps)
        q = qkv[:, :ah].reshape(b, c.n_heads, hd)
        k = qkv[:, ah : ah + kvd].reshape(b, n_kv, hd)
        v = qkv[:, ah + kvd :].reshape(b, n_kv, hd)
        if c.use_qk_norm:
            q = _rms_rows(q, q_norm[l].float(), eps)
            k = _rms_rows(k, k_norm[l].float(), eps)
        q = _rope(q, cos_r, sin_r) * (1.0 / hd**0.5)
        k = _rope(k, cos_r, sin_r)
        quant = k_scale is not None
        att = _layer_attention(q, k, v, k_cache[l], v_cache[l], k_scale[l] if quant else None,
                               v_scale[l] if quant else None, p_read)
        # The step's rows, after every read of this layer; masked rows keep theirs.
        if quant:
            for new, codes, scales in ((k, k_cache, k_scale), (v, v_cache, v_scale)):
                nq, ns = _quant_rows(new)
                codes[l, bi, :, rows] = torch.where(ok[:, None, None], nq, codes[l, bi, :, rows])
                scales[l, bi, :, rows] = torch.where(ok[:, None], ns, scales[l, bi, :, rows])
        else:
            for new, cache in ((k, k_cache), (v, v_cache)):
                cache[l, bi, :, rows] = torch.where(ok[:, None, None], new.to(cache.dtype), cache[l, bi, :, rows])
        x = qmatmul_w8a16_plain(att, wo, l, residual=x)
        gate_up = qmatmul_w8a16_plain(x, w13, l, norm_w=rms_ffn, eps=eps)
        x = qmatmul_w8a16_plain(gate_up, w2, l, swiglu=True, residual=x)
    if lm_head is None:
        if greedy:
            raise ValueError("greedy decode needs the fused head (lm_head and rms_final)")
        return x, None
    logits = qmatmul_w8a16_plain(x, lm_head, None, norm_w=rms_final.float(), eps=eps)
    if greedy:
        return x, logits[:, : c.vocab_size].argmax(dim=-1).to(torch.int32)  # first max
    return x, logits


# ------------------------------------------------------------------ the kernel
class _MatPlan(ctypes.Structure):
    _fields_ = [("codes", ctypes.c_void_p), ("scales", ctypes.c_void_p), ("n", ctypes.c_int),
                ("d", ctypes.c_int), ("splits", ctypes.c_int), ("kc", ctypes.c_int), ("q4", ctypes.c_int)]


_PTRS = ("x_in", "x_out", "rms_att", "rms_ffn", "q_norm", "k_norm", "rms_final", "cos", "sin", "k_cache",
         "v_cache", "k_scale", "v_scale", "pos", "write_ok", "logits", "tokens", "part_a", "part_b", "qkv", "att",
         "act", "ssq", "red_val", "red_idx", "counters")
_INTS = ("B", "dim", "ah", "kvd", "hidden", "n_kv", "kv_mul", "T", "L", "g", "vocab", "v_pad",
         "cache_type", "use_qk_norm", "has_head", "greedy", "chunk_rows", "scale_slots", "stage_bytes", "n_stages",
         "strip_counters")


class _Params(ctypes.Structure):
    """The mirror of ``struct Params`` in ``csrc/decode_megakernel.cu``."""

    _fields_ = ([("mat", _MatPlan * 5)] + [(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_int) for n in _INTS] + [("eps", ctypes.c_float), ("scale", ctypes.c_float)]
                + [("stamps", ctypes.c_void_p)])


# The kernel's fixed layout (``decode_megakernel_layout`` returns the same, and
# the wrapper checks it at first use): threads of a block, the mbarrier and
# scratch bytes in front of the ring of stages, the most stages, the columns of a
# code box (a stage holds four, 128-byte swizzled), a stage's scale row stride,
# the activation slots staged at a time, the ring's alignment.
THREADS = 288  # eight consumer warps and one producer warp
BAR_BYTES = 1024
SCRATCH_BYTES = 37888
MAX_STAGES = 16
BOX_COLS = 128
SCALE_STRIDE = 1024  # a scale row: 512 bf16
PIECE = 1024
ALIGN = 1024
SMEM_BYTES = 232448  # the most dynamic shared memory a block takes on the H100
STRIP = 512  # output columns of an item
CHUNK_ROWS = (64, 32, 16)  # code rows of a stage, the first that fits STAGE_CAP
STAGE_CAP = 40 * 1024


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("decode_megakernel")
    lib.decode_megakernel.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.decode_megakernel.restype = ctypes.c_int
    lib.decode_megakernel_grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.decode_megakernel_grid.restype = ctypes.c_int
    lib.decode_megakernel_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.decode_megakernel_layout.restype = None
    i = ctypes.c_int
    lib.decode_megakernel_stages.argtypes = [ctypes.POINTER(_MatPlan), i, i, i, i, i, ctypes.POINTER(i), i]
    lib.decode_megakernel_stages.restype = i
    out = (ctypes.c_int * 9)()
    lib.decode_megakernel_layout(out)
    want = (THREADS, BAR_BYTES, SCRATCH_BYTES, MAX_STAGES, BOX_COLS, SCALE_STRIDE, PIECE, ALIGN,
            ctypes.sizeof(_Params))
    if tuple(out) != want:
        raise RuntimeError(f"decode_megakernel: the kernel's layout {tuple(out)} is not the wrapper's {want}")
    return lib


@functools.cache
def _grid(smem: int, device_index: int) -> int:
    """The kernel's cooperative grid on the current device (cached per device)."""
    out = ctypes.c_int(0)
    build.check(_lib().decode_megakernel_grid(smem, ctypes.byref(out)), "decode_megakernel occupancy")
    return out.value


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """A block's ring of stages: ``chunk_rows`` code rows (INT4: packed rows)
    of one item a stage, as four TMA boxes of 128 columns, then
    ``scale_slots`` bf16 scale rows (the most groups a chunk touches, over the
    layer matrices' and the classifier's group rows); ``n_stages`` of
    ``stage_bytes`` behind the mbarriers, the scratch and the alignment;
    ``smem_bytes`` in all."""

    chunk_rows: int
    scale_slots: int
    stage_bytes: int
    n_stages: int
    smem_bytes: int


def _scale_slots(rows: int, group_rows: int) -> int:
    """The most scale groups ``rows`` code rows starting at a multiple of
    ``rows`` can touch."""
    return min(rows, (rows - 1) // group_rows + 2)


@functools.cache
def ring_plan(g: int, q4: bool = False) -> RingPlan:
    """The ring for group size ``g`` (``q4``: INT4 layer matrices, whose
    groups are g/2 packed rows; the classifier's are g rows): the largest
    stage of ``CHUNK_ROWS`` that fits ``STAGE_CAP``, and as many stages as
    the shared memory holds."""
    group_rows = (g // 2 if q4 else g, g)
    for rows in CHUNK_ROWS:
        slots = max(_scale_slots(rows, r) for r in group_rows)
        stage = -(-(STRIP // BOX_COLS * rows * BOX_COLS + slots * SCALE_STRIDE) // ALIGN) * ALIGN
        if stage <= STAGE_CAP:
            break
    fixed = BAR_BYTES + SCRATCH_BYTES + ALIGN
    n = min(MAX_STAGES, (SMEM_BYTES - fixed) // stage)
    return RingPlan(rows, slots, stage, n, fixed + n * stage)


# What an item costs a block besides its weight rows, in bytes of the stream:
# staging its activation, summing the warps, writing and arriving (a few µs
# at a block's ~24 GB/s share of the card's rate).
ITEM_BYTES = 96 * 1024


@functools.cache
def split_plan(n: int, d: int, rows: int, grid: int, g: int, q4: bool = False) -> tuple[int, int]:
    """(splits, rows per split) of a matmul phase: the split of the
    contraction into whole 64-code-row multiples (INT8 64 rows, INT4 128)
    that gives the slowest block the least work over its rounds of
    (512-column strip, split) items: a byte a weight (the consumers'
    dequantization and products set the pace, INT4's half-byte weights
    included) and its scales, ``ITEM_BYTES`` an item, and its share of the
    partials written and read back."""
    strips = -(-d // STRIP)
    align = 128 if q4 else 64
    per_row = min(STRIP, d) * (1.0 + 2.0 / g)
    best = None
    for want in range(1, max(1, n // align) + 1):
        kc = -(-n // want // align) * align
        splits = -(-n // kc)
        rounds = -(-strips * splits // grid)
        cost = rounds * (kc * per_row + ITEM_BYTES) + splits * rows * d * 8.0 / grid
        if best is None or cost < best[0]:
            best = (cost, splits, kc)
    return best[1], best[2]


def _mat_shapes(config, v_pad: int | None) -> dict[str, tuple[int, int]]:
    """(N, D) of each matmul phase, in the kernel's order (the classifier
    only with ``v_pad``)."""
    c = config
    shapes = {"wqkv": (c.dim, c.all_heads_dim + 2 * c.kv_dim), "wo": (c.all_heads_dim, c.dim),
              "w13": (c.dim, 2 * c.hidden_dim), "w2": (c.hidden_dim, c.dim)}
    if v_pad:
        shapes["lm_head"] = (c.dim, v_pad)
    return shapes


# ------------------------------------------------------- the schedule, mirrored
def strips_of(d: int, paired: bool = False) -> int:
    """Strips of a matmul phase's output columns: 512 columns each, or for
    w13 (``paired``: [gate | up], d/2 each) 256 gate and the same 256 up
    columns each."""
    return -(-(d // 2) // (STRIP // 2)) if paired else -(-d // STRIP)


def item_of(n: int, d: int, splits: int, kc: int, q4: bool, it: int,
            paired: bool = False) -> tuple[int, int, int, int, int]:
    """Item ``it`` of a matmul phase, as the kernel's ``item_of``: (strip,
    split, valid columns of the strip (``paired``: of each half), first code
    row, end code row); INT4 code rows are packed rows."""
    strips = strips_of(d, paired)
    si, ki = it % strips, it // strips
    k0, k1 = ki * kc, min(n, ki * kc + kc)
    width = min(STRIP // 2, d // 2 - si * (STRIP // 2)) if paired else min(STRIP, d - si * STRIP)
    return si, ki, width, (k0 // 2 if q4 else k0), (k1 // 2 if q4 else k1)


@dataclasses.dataclass(frozen=True)
class MatSchedule:
    """One matmul phase of the kernel's schedule: its [n, d] matrix, the
    split of its contraction (``splits`` of ``kc`` rows), whether its codes
    are INT4, its strips (``paired``: w13's, 256 gate and 256 up columns
    each) and the code rows of a scale group."""

    name: str
    n: int
    d: int
    splits: int
    kc: int
    q4: bool
    paired: bool
    strips: int
    group_rows: int


def block_stages(mat: MatSchedule, ring: RingPlan, grid: int, block: int) -> list[tuple[int, int, int, int, int]]:
    """The stages block ``block`` streams for one matmul phase, in the order
    its producer fills them (the kernel's ``produce_mat``, which
    ``decode_megakernel_stages`` lists on the card): (strip, split, first
    code row, code rows, scale rows)."""
    out = []
    gr = mat.group_rows
    for it in range(block, mat.strips * mat.splits, grid):
        si, ki, _, c0, c1 = item_of(mat.n, mat.d, mat.splits, mat.kc, mat.q4, it, mat.paired)
        for r0 in range(c0, c1, ring.chunk_rows):
            rows = min(ring.chunk_rows, c1 - r0)
            out.append((si, ki, r0, rows, (r0 + rows - 1) // gr - r0 // gr + 1))
    return out


def phase_names(n_layers: int, has_head: bool, greedy: bool) -> list[str]:
    """The name of each phase of one launch, in order; each but the last
    ends at a grid barrier."""
    tail = (["head", "argmax"] if greedy else ["head"]) if has_head else []
    return list(LAYER_PHASES) * n_layers + tail


# The phases of a layer, each ending at a grid barrier: the residuals are folded
# into wo and w2 (the strip's last item adds them), SwiGLU into w2's activation,
# the chunks' merge into attention (the last chunk item of a (row, kv head)).
LAYER_PHASES = ("wqkv", "attention", "wo", "w13", "w2")


def barriers_per_step(n_layers: int, has_head: bool, greedy: bool) -> int:
    return len(phase_names(n_layers, has_head, greedy)) - 1


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The whole step as the kernel walks it: the ring, the matmul phases in
    the kernel's order (wqkv, wo, w13, w2, the classifier), the name of every
    phase of the launch and the grid barriers between them."""

    ring: RingPlan
    mats: tuple[MatSchedule, ...]
    phases: tuple[str, ...]
    barriers: int


@functools.cache
def schedule(config, b: int, grid: int, v_pad: int | None = None, q4: bool = False,
             greedy: bool = False) -> Schedule:
    """The launch's schedule at ``b`` rows on a grid of ``grid`` blocks
    (``v_pad``: the classifier's columns; ``q4``: INT4 layer matrices): what
    the wrapper hands the kernel, and what the tests hold to the kernel's own
    walk."""
    g = config.group_size
    mats = []
    for name, (n, d) in _mat_shapes(config, v_pad).items():
        mq4 = q4 and name != "lm_head"
        splits, kc = split_plan(n, d, b, grid, g, mq4)
        paired = name == "w13"
        mats.append(MatSchedule(name, n, d, splits, kc, mq4, paired, strips_of(d, paired), g // 2 if mq4 else g))
    head = v_pad is not None
    return Schedule(ring_plan(g, q4), tuple(mats), tuple(phase_names(config.n_layers, head, greedy)),
                    barriers_per_step(config.n_layers, head, greedy))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode_stack_megakernel: {msg}")


def _ptr(t):
    return None if t is None else t.data_ptr()


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """The kernel's barrier and arrival counters on ``dev``, made once
    (zeros; grown when a launch needs more): each launch leaves the arrival
    counts at zero and the barrier's counter where the next launch can start
    from it, so a step adds no device op.  One stream at a time may use
    them."""
    t = _COUNTERS.get(dev)
    if t is None or t.numel() < n:
        t = _COUNTERS[dev] = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
    return t


def decode_stack_megakernel(
    config, x, rms_att, rms_ffn, q_norm, k_norm, cos, sin, wqkv, wo, w13, w2, k_cache, v_cache, pos,
    rms_final=None, lm_head=None, write_ok=None, k_scale=None, v_scale=None, *, eps=1e-6,
    greedy=False, stamps=None,
):
    """One whole decode step over every layer → ``(x_out [B, dim] f32,
    head)``: ``head`` is the logits ``[B, v_pad]`` f32 with ``lm_head`` and
    ``rms_final``, the first-max argmax ``[B]`` int32 over the first
    ``vocab_size`` columns with ``greedy``, else None.

    x ``[B, dim]`` (the embedded tokens, f32), the norm weights ``[L, dim]``
    and ``[L, hd]`` f32, cos/sin ``[B, hd/2]`` f32 (RoPE rows at each
    position), the linear weights stacked ``[L, N, D]`` with bf16 scales
    (all four INT8, or all four ``Q4Tensor`` with codes ``[L, N/2, D]``; the
    classifier INT8),
    the caches ``[L, B, n_kv, T, hd]`` (f32, bf16, or int8 with f32 scales
    ``[L, B, n_kv, T]``), pos ``[B]`` int32, write_ok ``[B]`` (None: every
    row writes).  The caches are updated in place.

    ``stamps`` (card only, for the phase breakdown): int64 ``[grid,
    barriers + 2, 2]`` (``schedule(...).barriers``), where each block writes the device
    clock (ns) at its start, as it finishes each phase and leaves the grid
    barrier after it, and at its end (``phase_breakdown`` reads them).
    """
    if x.device.type == "cpu":
        return decode_stack_megakernel_plain(
            config, x, rms_att, rms_ffn, q_norm, k_norm, cos, sin, wqkv, wo, w13, w2, k_cache, v_cache, pos,
            rms_final, lm_head, write_ok, k_scale, v_scale, eps=eps, greedy=greedy,
        )
    _need(x.device.type == "cuda", f"tensors on {x.device} are neither CPU nor CUDA")
    c = config
    b, dim = x.shape
    n_layers, cb, n_kv, t, hd = k_cache.shape
    dev = x.device
    _need(1 <= b <= MAX_BATCH and cb == b, f"{b} rows over a cache of {cb}; the kernel takes 1..{MAX_BATCH}")
    _need(hd == HEAD_DIM == c.head_dim and dim == c.dim and n_kv == c.n_kv_heads, "shapes do not fit the config")
    _need(k_cache.dtype in _CACHE_TYPES and v_cache.dtype == k_cache.dtype and v_cache.shape == k_cache.shape,
          "k_cache and v_cache must be f32, bf16 or int8 of one shape")
    _need(k_cache.is_contiguous() and v_cache.is_contiguous(), "the caches must be contiguous")
    quant = k_cache.dtype == torch.int8
    _need(quant == (k_scale is not None) == (v_scale is not None), "an INT8 cache needs both scales")
    if quant:
        for s in (k_scale, v_scale):
            _need(s.shape == k_cache.shape[:-1] and s.dtype == torch.float32 and s.is_contiguous(),
                  "scales must be contiguous f32 [L, B, n_kv, T]")
    _need((lm_head is None) == (rms_final is None), "the head needs lm_head and rms_final")
    _need(not greedy or lm_head is not None, "greedy decode needs the fused head (lm_head and rms_final)")
    _need(pos.dtype == torch.int32 and pos.shape == (b,) and pos.is_contiguous(), "pos must be int32 [B]")
    g = c.group_size
    q4 = isinstance(wqkv, Q4Tensor)
    _need(all(isinstance(w, Q4Tensor) == q4 for w in (wo, w13, w2)), "the layer matrices mix INT8 and INT4")
    _need(lm_head is None or not isinstance(lm_head, Q4Tensor), "the classifier must be INT8")
    _need(not q4 or g % 2 == 0, f"INT4 group size {g} must be even")
    mats = [wqkv, wo, w13, w2] + ([lm_head] if lm_head is not None else [])
    v_pad = lm_head.q.shape[-1] if lm_head is not None else None
    shapes = list(_mat_shapes(c, v_pad).values())
    f32 = torch.float32
    vecs = [x, rms_att, rms_ffn, q_norm, k_norm, cos, sin] + ([rms_final] if lm_head is not None else [])
    vecs = [v.contiguous() if v.dtype == f32 else v.float().contiguous() for v in vecs]
    x, rms_att, rms_ffn, q_norm, k_norm, cos, sin = vecs[:7]
    rms_final = vecs[7] if lm_head is not None else None
    _need(cos.shape == sin.shape == (b, hd // 2), "cos/sin must be [B, hd/2]")
    _need(rms_att.shape == rms_ffn.shape == (n_layers, dim) and q_norm.shape == k_norm.shape == (n_layers, hd),
          "norm weights must be [L, dim] and [L, hd]")
    for w, (n, d), name in zip(mats, shapes, ("wqkv", "wo", "w13", "w2", "lm_head")):
        stacked = name != "lm_head"
        packed = stacked and q4
        rows, code_dtype = (n // 2, torch.uint8) if packed else (n, torch.int8)
        _need(w.q.shape == ((n_layers, rows, d) if stacked else (n, d)) and w.q.dtype == code_dtype
              and w.q.is_contiguous(), f"{name} codes {tuple(w.q.shape)} do not fit")
        _need(w.scales.shape == ((n_layers, n // g, d) if stacked else (n // g, d))
              and w.scales.dtype == torch.bfloat16 and w.scales.is_contiguous(),
              f"{name} scales must be contiguous bf16 (cast_weight_scales does that)")
        _need(n % 8 == 0 and d % 16 == 0 and w.q.data_ptr() % 16 == 0 and w.scales.data_ptr() % 16 == 0,
              f"{name}: N={n} must be a multiple of 8, D={d} of 16, the weights 16-byte aligned")
    ok = None
    if write_ok is not None:
        ok = write_ok.to(torch.int32).reshape(b).contiguous()
    tensors = [k_cache, v_cache, pos, *vecs] + [t_ for w in mats for t_ in w] + [
        s for s in (k_scale, v_scale, ok) if s is not None]
    _need(all(t_.device == dev for t_ in tensors), "all tensors must be on one device")

    grid = _grid(ring_plan(g, q4).smem_bytes, dev.index if dev.index is not None else torch.cuda.current_device())
    sched = schedule(c, b, grid, v_pad, q4, greedy)
    ring = sched.ring
    strips = [m.strips for m in sched.mats]
    n_chunks = -(-t // CHUNK)
    # Split partials [split, B, strips * 512]: wqkv, w13 and the classifier, then wo and w2.
    part = [m.splits * b * m.strips * STRIP for m in sched.mats]
    part_a = torch.empty(max(part[i] for i in (0, 2, 4) if i < len(part)), dtype=f32, device=dev)
    part_b = torch.empty(max(part[1], part[3]), dtype=f32, device=dev)
    qkv = torch.empty(b * shapes[0][1], dtype=f32, device=dev)
    att = torch.empty(b * n_kv * n_chunks * c.kv_mul * (2 + hd), dtype=f32, device=dev)
    act = torch.empty(b * max(c.all_heads_dim, c.hidden_dim), dtype=f32, device=dev)
    ssq = torch.empty(strips[1] * b, dtype=f32, device=dev)
    x_out = torch.empty(b, dim, dtype=f32, device=dev)
    logits = torch.empty(b, v_pad, dtype=f32, device=dev) if lm_head is not None else None
    tokens = torch.empty(b, dtype=torch.int32, device=dev) if greedy else None
    red_val = torch.empty(strips[-1] * b, dtype=f32, device=dev) if greedy else None
    red_idx = torch.empty(strips[-1] * b, dtype=torch.int32, device=dev) if greedy else None
    strip_counters = max(strips)
    counters = _counters(dev, 1 + strip_counters + b * n_kv)

    prm = _Params()
    for i, (w, m) in enumerate(zip(mats, sched.mats)):
        prm.mat[i] = _MatPlan(w.q.data_ptr(), w.scales.data_ptr(), m.n, m.d, m.splits, m.kc, int(m.q4))
    ptrs = dict(x_in=x, x_out=x_out, rms_att=rms_att, rms_ffn=rms_ffn, q_norm=q_norm, k_norm=k_norm,
                rms_final=rms_final, cos=cos, sin=sin, k_cache=k_cache, v_cache=v_cache, k_scale=k_scale,
                v_scale=v_scale, pos=pos, write_ok=ok, logits=logits, tokens=tokens, part_a=part_a, part_b=part_b,
                qkv=qkv, att=att, act=act, ssq=ssq, red_val=red_val, red_idx=red_idx, counters=counters)
    for name in _PTRS:
        setattr(prm, name, _ptr(ptrs[name]))
    ints = dict(B=b, dim=dim, ah=c.all_heads_dim, kvd=c.kv_dim, hidden=c.hidden_dim, n_kv=n_kv, kv_mul=c.kv_mul,
                T=t, L=n_layers, g=g, vocab=c.vocab_size, v_pad=v_pad or 0, cache_type=_CACHE_TYPES[k_cache.dtype],
                use_qk_norm=int(c.use_qk_norm), has_head=int(lm_head is not None), greedy=int(greedy),
                chunk_rows=ring.chunk_rows, scale_slots=ring.scale_slots, stage_bytes=ring.stage_bytes,
                n_stages=ring.n_stages, strip_counters=strip_counters)
    for name in _INTS:
        setattr(prm, name, ints[name])
    prm.eps, prm.scale = eps, 1.0 / math.sqrt(hd)
    if stamps is not None:
        slots = sched.barriers + 2
        _need(stamps.dtype == torch.int64 and stamps.shape == (grid, slots, 2) and stamps.is_contiguous()
              and stamps.device == dev, f"stamps must be contiguous int64 [{grid}, {slots}, 2] on {dev}")
        prm.stamps = stamps.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().decode_megakernel(ctypes.byref(prm), grid, ring.smem_bytes, stream)
    build.check(err, "decode_stack_megakernel")
    LAUNCHES["decode_megakernel_q4" if q4 else "decode_megakernel"] += 1
    return x_out, (tokens if greedy else logits)


def kernel_stages(mat: MatSchedule, g: int, ring: RingPlan, grid: int, block: int) -> list[tuple[int, ...]]:
    """The stages block ``block`` streams for ``mat`` as the kernel's own
    walk lists them (``decode_megakernel_stages``; card builds only): what
    ``block_stages`` mirrors."""
    index = ("wqkv", "wo", "w13", "w2", "lm_head").index(mat.name)
    plan = _MatPlan(None, None, mat.n, mat.d, mat.splits, mat.kc, int(mat.q4))
    cap = -(-mat.strips * mat.splits // grid) * -(-mat.kc // ring.chunk_rows)
    out = (ctypes.c_int * (5 * cap))()
    n = _lib().decode_megakernel_stages(ctypes.byref(plan), index, g, ring.chunk_rows, grid, block, out, cap)
    if n > cap:
        raise RuntimeError(f"decode_megakernel_stages: {n} stages past the {cap} expected")
    return [tuple(out[5 * k: 5 * k + 5]) for k in range(n)]


def launch_grid(g: int, q4: bool = False) -> int:
    """The grid the kernel takes at group size ``g`` on the current device
    (card only)."""
    return _grid(ring_plan(g, q4).smem_bytes, torch.cuda.current_device())


def phase_breakdown(stamps, names: list[str]) -> dict[str, dict[str, float]]:
    """Per phase kind, the median over its occurrences (the layers) in µs
    of: ``work``, the last block's finish minus the first block's release
    into the phase (its leave of the barrier before, or its start);
    ``barrier``, the first block's leave of the barrier after the phase minus
    the last block's finish (0 for the last phase); ``spread``, the last
    block's finish minus the first's; ``wait``, the mean over blocks of each
    block's own leave of that barrier minus its own finish (what a block
    spends there, the spread's share included).  ``stamps``: int64 ``[grid,
    slots, 2]`` as the kernel writes them (``len(names) + 1`` slots)."""
    st = _stamps(stamps, names)
    rel = (st - st[:, 0, 0].min()).double() / 1e3
    rows: dict[str, list[tuple[float, float, float, float]]] = {}
    for i, name in enumerate(names):
        release = float(rel[:, i, 1].min())
        fin = rel[:, i + 1, 0]
        last = float(fin.max())
        leave = float(rel[:, i + 1, 1].min()) if i + 1 < len(names) else last
        wait = float((rel[:, i + 1, 1] - fin).mean()) if i + 1 < len(names) else 0.0
        rows.setdefault(name, []).append((last - release, leave - last, last - float(fin.min()), wait))
    out = {}
    for name, vals in rows.items():
        cols = list(zip(*vals))
        out[name] = {k: float(torch.tensor(c, dtype=torch.float64).median())
                     for k, c in zip(("work", "barrier", "spread", "wait"), cols)}
        out[name]["count"] = len(vals)
    return out


def barrier_wait_share(stamps, names: list[str]) -> float:
    """The share of the stamped launch (first start to last end) that the
    mean block spends at grid barriers, from its finish of a phase to its
    leave of the barrier after it."""
    st = _stamps(stamps, names).double()
    waits = (st[:, 1:-1, 1] - st[:, 1:-1, 0]).sum(dim=1)
    return float(waits.mean() / (st[:, -1, 0].max() - st[:, 0, 0].min()))


def _stamps(stamps, names: list[str]) -> torch.Tensor:
    st = stamps.to("cpu", torch.int64) if isinstance(stamps, torch.Tensor) else torch.as_tensor(stamps)
    if st.shape[1] != len(names) + 1:
        raise ValueError(f"{st.shape[1]} stamp slots for {len(names)} phases")
    return st


def split_plans(config, b: int, grid: int, v_pad: int | None = None, q4: bool = False) -> dict[str, tuple[int, int]]:
    """The kernel's (splits, rows per split) of each matmul phase at ``b``
    rows on a grid of ``grid`` blocks (for reports); ``q4``: INT4 layers."""
    return {m.name: (m.splits, m.kc) for m in schedule(config, b, grid, v_pad, q4).mats}
