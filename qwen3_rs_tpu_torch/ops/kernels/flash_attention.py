"""Position-bounded GQA decode attention: the Hopper kernel and its plain
version.

``flash_decode`` is the S = 1 attention of one layer over the stacked dense
cache ``[L, B, n_kv, T, hd]``: query row b attends over the cache rows
``t < pos[b]`` plus the step's own key and value, which are not cached yet.
It replaces the reference package's ``flash_gqa_decode_stacked``.  f32, bf16
and INT8 caches; an INT8 cache passes per-row scales ``[L, B, n_kv, T]``, and
the K scale multiplies the score, the V scale the probability.

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches ``csrc/flash_decode.cu`` or raises.  Unlike the Pallas
kernel it has no minimum window and no block divisibility: every S = 1
dense-cache decode step on the card takes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, build

HEAD_DIM = 128  # the kernel's head_dim
CHUNK = 128  # cache rows per block of the kernel's first pass
_CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


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
    lib.flash_decode.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, p, p, p, p]
    lib.flash_decode.restype = ctypes.c_int
    return lib


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


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
    _need(q.device.type == "cuda", f"tensors on {q.device} are neither CPU nor CUDA")
    b, n_heads, hd = q.shape
    n_layers, cb, n_kv, t_max, chd = k_all.shape
    _need(hd == HEAD_DIM and chd == hd, f"head_dim {hd} (the kernel takes {HEAD_DIM})")
    _need(cb == b and n_heads % n_kv == 0, f"q {tuple(q.shape)} does not fit the cache {tuple(k_all.shape)}")
    kv_mul = n_heads // n_kv
    _need(kv_mul in (1, 2, 4, 8), f"kv_mul {kv_mul} not in (1, 2, 4, 8)")
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

    n_chunks = -(-t_max // CHUNK)
    slots = b * n_kv * n_chunks * kv_mul
    part_ml = torch.empty(slots * 2, dtype=torch.float32, device=q.device)
    part_acc = torch.empty(slots * hd, dtype=torch.float32, device=q.device)
    out = torch.empty(b, n_heads, hd, dtype=torch.float32, device=q.device)
    row = b * n_kv * t_max  # cache rows per layer
    esz = k_all.element_size()
    err = _lib().flash_decode(
        qf.data_ptr(),
        kn.data_ptr(),
        vn.data_ptr(),
        k_all.data_ptr() + layer * row * hd * esz,
        v_all.data_ptr() + layer * row * hd * esz,
        k_scale_all.data_ptr() + layer * row * 4 if quant else None,
        v_scale_all.data_ptr() + layer * row * 4 if quant else None,
        pos.data_ptr(),
        _CACHE_TYPES[k_all.dtype],
        b,
        n_kv,
        kv_mul,
        t_max,
        1.0 / hd**0.5,
        part_ml.data_ptr(),
        part_acc.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
