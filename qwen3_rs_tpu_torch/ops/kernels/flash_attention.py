"""Position-bounded GQA decode attention: the Hopper kernel and its plain
version.

``flash_decode`` is the S = 1 attention of one layer over the stacked dense
cache ``[L, B, n_kv, T, hd]``: query row b attends over the cache rows
``t < pos[b]`` plus the step's own key and value, which are not cached yet.
It replaces the reference package's ``flash_gqa_decode_stacked``.  f32, bf16
and INT8 caches; an INT8 cache passes per-row scales ``[L, B, n_kv, T]``, and
the K scale multiplies the score, the V scale the probability.

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches a kernel or raises.  At every head_dim that is a multiple
of 128 up to 1024 over a cache of a multiple of 16 rows
(``one_launch_takes``) that is the one-launch decode kernel of
``csrc/paged_decode.cu`` (#9's; past 256 its kernel past 256), on the layer
``[B, n_kv, T, hd]`` viewed as a pool of B pages of T rows, request b's page
being b: a split plan made on the device from the positions over the live
rows only, TMA copies, the last block of each kv head merging its splits.
Elsewhere it is the two-pass kernel of ``csrc/flash_decode.cu``
(``flash_decode_two_pass``, which ``chip_smoke.py`` also times beside the
other).  Both take any number of query heads per kv head, and the two-pass
kernel every head_dim that is a multiple of 128 (``takes_head_dim``; past
512 in 128-column blocks).
``decode_supported`` is the reference package's gate, copied; the forward
asks it without its minimum window (``MIN_SEQ_LEN``, a speed choice on the
reference's chip, not a limit of either kernel), and a shape it refuses takes
the plain attention.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, build, paged_attention

CHUNK = 128  # cache rows per block of the two-pass kernel's first pass
_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def takes_head_dim(hd: int) -> bool:
    """Whether the kernel takes head_dim ``hd``: every positive multiple of
    128, as the reference's gates admit (a template instance up to 512, the
    column-blocked kernels past it)."""
    return hd > 0 and hd % 128 == 0


# The reference package's gate: its cache-block candidates and the window
# from which its kernel engages.
MIN_SEQ_LEN = 512
_BLK_CANDIDATES = (512, 256, 128)


def _pick_blk(t: int) -> int | None:
    return next((b for b in _BLK_CANDIDATES if t % b == 0), None)


def decode_supported(n_heads: int, n_kv: int, head_dim: int, t: int, min_seq_len: int = MIN_SEQ_LEN) -> bool:
    """The reference package's gate for its flash-decode kernel: a
    128-multiple head_dim, a cache of ``t`` rows that a block size divides,
    at least ``min_seq_len`` rows, whole query heads per kv head."""
    return head_dim % 128 == 0 and _pick_blk(t) is not None and t >= min_seq_len and n_heads % n_kv == 0


def flash_decode_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_all: torch.Tensor | None = None,
    v_scale_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: one softmax over [self, cache rows < pos]."""
    b, n_heads, hd = q.shape
    n_kv = k_all.shape[2]
    kv_mul = n_heads // n_kv
    qs = (q.float() * (1.0 / hd**0.5)).reshape(b, n_kv, kv_mul, hd)
    s_self = torch.einsum("bnmh,bnh->bnm", qs, k_new.float())[..., None]
    pos_l = pos.to(device="cpu", dtype=torch.int64)
    p_max = int(pos_l.max())
    kc = k_all[layer, :, :, :p_max].float()  # [B, KV, P, hd]
    vc = v_all[layer, :, :, :p_max].float()
    sc = torch.einsum("bnmh,bnth->bnmt", qs, kc)
    if k_scale_all is not None:
        sc = sc * k_scale_all[layer, :, :, None, :p_max]
    valid = (torch.arange(p_max)[None, :] < pos_l[:, None]).to(q.device)  # [B, P]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    vc = vc.masked_fill(~valid[:, None, :, None], 0.0)  # rows >= pos take no part
    scores = torch.cat([s_self, sc], dim=-1)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    denom = e.sum(dim=-1, keepdim=True)
    pc = e[..., 1:]
    if v_scale_all is not None:
        pc = pc * v_scale_all[layer, :, :, None, :p_max]
    out = e[..., :1] * v_new.float()[:, :, None, :] + torch.einsum("bnmt,bnth->bnmh", pc, vc)
    return (out / denom).reshape(b, n_heads, hd)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_decode")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, p, p, p, p]
    lib.flash_decode.restype = ctypes.c_int
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def one_launch_takes(hd: int, t_max: int) -> bool:
    """Whether ``flash_decode`` launches the one-launch decode kernel for a
    cache of ``t_max`` rows at head_dim ``hd`` (else the two-pass kernel):
    the one-launch kernel's head_dims and pages (``split_kernel_takes``:
    every multiple of 128 up to 1024, past 256 on the kernel past 256), with
    the whole layer as a request's one page, over f32, bf16 and INT8 caches
    alike.  An INT8 cache's tensor-core stage splits q and P into three bf16
    terms: with two its output missed the 1e-5 that #4 is held to (1.18e-5
    at T = 208, 3 query heads a kv head, on the card)."""
    return paged_attention.split_kernel_takes(hd, t_max)


def _checked(q, k_new, v_new, k_all, v_all, pos, layer, k_scale_all, v_scale_all):
    """The checked inputs of a launch on the card: q, k_new and v_new f32
    contiguous, the layer's cache and scale pointers."""
    _need(q.device.type == "cuda", f"tensors on {q.device} are neither CPU nor CUDA")
    b, n_heads, hd = q.shape
    n_layers, cb, n_kv, t_max, chd = k_all.shape
    _need(takes_head_dim(hd) and chd == hd, f"head_dim {hd} (the kernel takes positive multiples of 128)")
    _need(cb == b and n_heads % n_kv == 0, f"q {tuple(q.shape)} does not fit the cache {tuple(k_all.shape)}")
    _need(0 <= layer < n_layers, f"layer {layer} out of range")
    _need(v_all.shape == k_all.shape and v_all.dtype == k_all.dtype, "k_all and v_all differ")
    _need(k_all.dtype in _CACHE_TYPES, f"cache dtype {k_all.dtype} is not f32/bf16/int8")
    _need(k_all.is_contiguous() and v_all.is_contiguous(), "the cache must be contiguous")
    quant = k_all.dtype == torch.int8
    _need(quant == (k_scale_all is not None) == (v_scale_all is not None), "INT8 cache needs both scales")
    tensors = [k_all, v_all]
    if quant:
        for s in (k_scale_all, v_scale_all):
            _need(s.shape == k_all.shape[:-1] and s.dtype == torch.float32 and s.is_contiguous(),
                  "scales must be contiguous f32 [L, B, n_kv, T]")
        tensors += [k_scale_all, v_scale_all]
    _need(pos.dtype == torch.int32 and pos.shape == (b,), "pos must be int32 [B]")
    tensors.append(pos)
    _need(all(t.device == q.device for t in tensors), "all tensors must be on one device")
    qf = q.float().contiguous()
    kn = k_new.float().contiguous()
    vn = v_new.float().contiguous()
    _need(kn.shape == (b, n_kv, hd) and vn.shape == kn.shape, "k_new/v_new must be [B, n_kv, hd]")
    row = b * n_kv * t_max  # cache rows per layer
    esz = k_all.element_size()
    ptrs = (k_all.data_ptr() + layer * row * hd * esz, v_all.data_ptr() + layer * row * hd * esz,
            k_scale_all.data_ptr() + layer * row * 4 if quant else None,
            v_scale_all.data_ptr() + layer * row * 4 if quant else None)
    return qf, kn, vn, ptrs


def flash_decode(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    *,
    k_scale_all: torch.Tensor | None = None,
    v_scale_all: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode attention of layer ``layer`` → ``[B, n_heads, hd]`` f32.

    q ``[B, n_heads, hd]``, k_new/v_new ``[B, n_kv, hd]``, k_all/v_all
    ``[L, B, n_kv, T, hd]``, pos ``[B]`` int (cache rows < pos[b] are valid;
    on the card an int32 tensor on the same device, at most T).
    """
    if q.device.type == "cpu":
        return flash_decode_plain(
            q, k_new, v_new, k_all, v_all, pos, layer,
            k_scale_all=k_scale_all, v_scale_all=v_scale_all,
        )
    qf, kn, vn, ptrs = _checked(q, k_new, v_new, k_all, v_all, pos, layer, k_scale_all, v_scale_all)
    if one_launch_takes(q.shape[-1], k_all.shape[3]):
        out = torch.empty(qf.shape, dtype=torch.float32, device=q.device)
        paged_attention.one_launch(qf, kn, vn, k_all, ptrs, None, pos, q.shape[1] // k_all.shape[2], out, None,
                                   "flash_decode")
        return out
    return _two_pass(qf, kn, vn, k_all, ptrs, pos)


def flash_decode_two_pass(q, k_new, v_new, k_all, v_all, pos, layer, *, k_scale_all=None, v_scale_all=None):
    """``flash_decode`` on the two-pass kernel of ``csrc/flash_decode.cu``
    whatever the shape (the wrapper's kernel at the head_dims and cache
    lengths that ``one_launch_takes`` refuses); its launches count under
    ``flash_decode``."""
    if q.device.type == "cpu":
        return flash_decode(q, k_new, v_new, k_all, v_all, pos, layer, k_scale_all=k_scale_all,
                            v_scale_all=v_scale_all)
    qf, kn, vn, ptrs = _checked(q, k_new, v_new, k_all, v_all, pos, layer, k_scale_all, v_scale_all)
    return _two_pass(qf, kn, vn, k_all, ptrs, pos)


def flash_decode_phases(q, k_new, v_new, k_all, v_all, pos, layer, *, k_scale_all=None, v_scale_all=None) -> dict:
    """Where one launch of the one-launch kernel on the dense layer spends
    its time (card only; ``paged_attention.paged_decode_phases``' breakdown
    from the kernel's clock stamps)."""
    _need(one_launch_takes(q.shape[-1], k_all.shape[3]), "the cache takes the two-pass kernel")
    qf, kn, vn, ptrs = _checked(q, k_new, v_new, k_all, v_all, pos, layer, k_scale_all, v_scale_all)
    return paged_attention.launch_phases(qf, kn, vn, k_all, ptrs, None, pos, q.shape[1] // k_all.shape[2])


def _two_pass(qf, kn, vn, k_all, ptrs, pos) -> torch.Tensor:
    """One call of the two-pass kernel on checked inputs."""
    b, n_heads, hd = qf.shape
    n_kv, t_max = k_all.shape[2], k_all.shape[3]
    kv_mul = n_heads // n_kv
    n_chunks = -(-t_max // CHUNK)
    slots = b * n_kv * n_chunks * kv_mul
    part_ml = torch.empty(slots * 2, dtype=torch.float32, device=qf.device)
    part_acc = torch.empty(slots * hd, dtype=torch.float32, device=qf.device)
    out = torch.empty(b, n_heads, hd, dtype=torch.float32, device=qf.device)
    err = _lib().flash_decode(
        qf.data_ptr(),
        kn.data_ptr(),
        vn.data_ptr(),
        *ptrs,
        pos.data_ptr(),
        _CACHE_TYPES[k_all.dtype],
        b,
        n_kv,
        kv_mul,
        t_max,
        hd,
        1.0 / hd**0.5,
        part_ml.data_ptr(),
        part_acc.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(qf.device).cuda_stream,
    )
    build.check(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
