"""Causal prefill attention over a fresh window: the Hopper kernel and its
plain version.

``causal_prefill_attention`` is pure causal GQA within a window that starts
at position 0 (no cache prefix): output row i attends to window rows j ≤ i,
and query head h reads kv head ``h // kv_mul``.  It replaces the reference
package's ``causal_prefill_attention`` (the splash kernel), with its
numerics: q is scaled by ``bf16(1/√hd)`` and rounded to bf16 before the
scores, scores and softmax are f32, P·V keeps P in f32, and the normalised
output is rounded to bf16.  Unlike the splash kernel it has no minimum
window and no block divisibility: the forward sends it every fresh window of
more than 256 rows whose shapes pass ``splash_prefill_supported`` (the
reference package's gate, asked at the window's power-of-two bucket, the
width the reference engine pads it to).  It takes any number of query heads
per kv head, and every head_dim that is a multiple of 128
(``takes_head_dim``).  Both routes are TMA-fed kernels on ``wgmma``: at 128
and 256 each warpgroup holds its query rows' whole output; past 256 a block
of 64 query rows computes the scores once in one warpgroup and shares P
through shared memory with one warpgroup for each 128-column piece of a
slice of at most 384 output columns (``wide_plan`` is its shape).

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/prefill_attention.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, build

QUERY_CHUNK = 512  # query rows per step of the plain version (bounds its score tensor)
_BLOCK = 1024  # the reference splash kernel's default block

# The past-256 kernel's layout (``wide`` in csrc/prefill_attention.cu).
WIDE_PIECE_COLS = 128  # output columns of a P.V warpgroup
WIDE_MAX_PV = 3  # P.V warpgroups a block
WIDE_KEYS = 32  # keys a K/V tile
WIDE_BOX = WIDE_KEYS * 128  # one 64-column box of a K or V tile (a ring slot)
WIDE_Q_BAND = 64 * 128  # one 64-column band of the block's 64 query rows
WIDE_MAX_SLOTS = 16
WIDE_MAX_V_STAGES = 4
WIDE_FIXED = 1024 + 2 * WIDE_Q_BAND + 2 * 2 * 64 * 4 + (2 * WIDE_MAX_SLOTS + 2 * WIDE_MAX_V_STAGES + 4) * 8
SMEM_MAX = 232448  # a block's shared memory on the H100


def takes_head_dim(hd: int) -> bool:
    """Whether the kernel takes head_dim ``hd``: every positive multiple of
    128, as the reference's gate admits."""
    return hd > 0 and hd % 128 == 0


def wide_plan(hd: int) -> dict:
    """The past-256 kernel's block at head_dim ``hd`` (``wide::plan_of``):
    hd/128 column pieces over ``slices`` blocks of ``npv`` P.V warpgroups
    (the last slice's spare ones idle); q resident in shared memory where it
    fits (``qres``), else loaded band by band; the most V stages (4 to 1)
    that leave room for 8 K ring slots of 4 KB (4 at two stages or fewer),
    and as many slots as the rest holds, at most 16; the block's shared
    memory bytes (``WIDE_FIXED``: alignment, the two P buffers, their
    rescale factors and sums, the barriers)."""
    if hd <= 256 or hd % 128:
        raise ValueError(f"wide_plan: head_dim {hd} is not a multiple of 128 past 256")
    pieces = hd // WIDE_PIECE_COLS
    slices = -(-pieces // WIDE_MAX_PV)
    npv = -(-pieces // slices)
    vbytes = npv * 2 * WIDE_BOX
    for qres in (1, 0):
        for vstages in range(WIDE_MAX_V_STAGES, 0, -1):
            qbytes = 64 * hd * 2 if qres else 2 * WIDE_Q_BAND
            slots = min(WIDE_MAX_SLOTS, (SMEM_MAX - WIDE_FIXED - qbytes - vstages * vbytes) // WIDE_BOX)
            if slots >= (8 if vstages > 2 else 4):
                return {"npv": npv, "slices": slices, "qres": qres, "vstages": vstages, "kslots": slots,
                        "smem": WIDE_FIXED + qbytes + vstages * vbytes + slots * WIDE_BOX}
    raise AssertionError("q's two bands, four V stages and 16 slots always fit")


def wide_kernel_plan(hd: int) -> dict:
    """``wide_plan`` as the kernel's source makes it (card only: the built
    library's ``causal_prefill_wide_plan``)."""
    out = (ctypes.c_int * 6)()
    build.check(_lib().causal_prefill_wide_plan(hd, out), "causal_prefill_wide_plan")
    return dict(zip(("npv", "slices", "qres", "vstages", "kslots", "smem"), list(out)))


def _effective_block(s: int) -> int:
    """The reference's splash block for a window of ``s`` rows: the largest
    of 1024, 512 that divides it, never below 512."""
    blk = max(min(_BLOCK, s), 512)
    while blk > 512 and s % blk:
        blk //= 2
    return blk


def splash_prefill_supported(s: int, head_dim: int, n_heads: int, n_kv: int) -> bool:
    """The reference package's gate for its splash prefill kernel: a
    128-multiple head_dim, a window its block divides, whole query heads per
    kv head."""
    blk = _effective_block(s)
    return head_dim % 128 == 0 and s % blk == 0 and s >= blk and n_heads % n_kv == 0


def q_scale(head_dim: int) -> float:
    """The attention scale as the reference applies it to a bf16 q: the
    Python float ``1/√hd`` taken to bf16 (a weakly typed scalar)."""
    return float(torch.tensor(1.0 / (head_dim**0.5)).to(torch.bfloat16))


def causal_prefill_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, in query chunks of ``QUERY_CHUNK`` rows; each
    chunk reads only the keys at or below its last row."""
    b, s, n_heads, hd = q.shape
    n_kv = k.shape[2]
    kv_mul = n_heads // n_kv
    qs = (q.float() * q_scale(hd)).to(torch.bfloat16).float().reshape(b, s, n_kv, kv_mul, hd)
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, s, QUERY_CHUNK):
        c1 = min(s, c0 + QUERY_CHUNK)
        sc = torch.einsum("bsnmh,bjnh->bnmsj", qs[:, c0:c1], kf[:, :c1])
        causal = torch.arange(c0, c1, device=q.device)[:, None] >= torch.arange(c1, device=q.device)[None, :]
        sc = sc.masked_fill(~causal, float("-inf"))
        m = sc.amax(dim=-1, keepdim=True)
        e = torch.exp(sc - m)
        o = torch.einsum("bnmsj,bjnh->bnmsh", e, vf[:, :c1]) / e.sum(dim=-1, keepdim=True)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, c1 - c0, n_heads, hd))
    return torch.cat(outs, dim=1).to(torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("prefill_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.causal_prefill_attention.argtypes = [p, p, p, p, i, i, i, i, i, f, p]
    lib.causal_prefill_attention.restype = ctypes.c_int
    lib.causal_prefill_wide_plan.argtypes = [i, p]
    lib.causal_prefill_wide_plan.restype = ctypes.c_int
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"causal_prefill_attention: {msg}")


def causal_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q ``[B, S, n_heads, hd]``, k/v ``[B, S, n_kv, hd]`` (bf16 on the card)
    → ``[B, S, n_heads, hd]`` bf16."""
    if q.device.type == "cpu":
        return causal_prefill_attention_plain(q, k, v)
    _need(q.device.type == "cuda", f"tensors on {q.device} are neither CPU nor CUDA")
    b, s, n_heads, hd = q.shape
    n_kv = k.shape[2]
    _need(takes_head_dim(hd), f"head_dim {hd} (the kernel takes positive multiples of 128)")
    _need(k.shape == v.shape == (b, s, n_kv, hd), f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    _need(n_heads % n_kv == 0, f"{n_heads} query heads over {n_kv} kv heads")
    _need(all(t.dtype == torch.bfloat16 for t in (q, k, v)), "q, k and v must be bf16")
    _need(q.device == k.device == v.device, "all tensors must be on one device")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    if b * s:
        err = _lib().causal_prefill_attention(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b, s, n_heads, n_kv, hd,
            q_scale(hd), torch.cuda.current_stream(q.device).cuda_stream,
        )
        build.check(err, "causal_prefill_attention")
        LAUNCHES["causal_prefill_attention"] += 1
    return out
