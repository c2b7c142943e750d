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
from .qmatmul import qmatmul_w8a16_plain

HEAD_A8_VARIANTS = ("deq-dot", "i8-seg", "i8-seg2")
A8_DEPTH_VARIANTS = ("bf16-full", "i8-seg64", "i8-full")
HEAD_A8_GROUP = 64
A8_SEG_DEPTH = {"i8-seg64": 64, "i8-full": 512}  # int32 depth before each flush into f32
# Each kernel against its plain version, relative to the largest value.  The tensor cores'
# f32 accumulation (deq-dot, bf16-full) rounds toward zero, not to nearest: over thousands of
# k-steps it drifts by ~2e-5, so these take #6's tolerance (1e-4).  The int8 dots are exact:
# i8-seg's f32 fixups differ only in summation order (1e-5), a8_depth's int arms not at all.
HEAD_A8_RTOL = {"deq-dot": 1e-4, "i8-seg": 1e-5, "i8-seg2": 1e-5}
A8_DEPTH_RTOL = {"bf16-full": 1e-4, "i8-seg64": 0.0, "i8-full": 0.0}
_STRIP_THREADS = (32, 16, 8, 4, 2)  # threads across a column strip of the one-call kernel
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
        "boundary_probe": ("boundary_onecall", [p, p, p, p, i, i, i, i, i, i, p]),
        "hbm_stream_bench": ("hbm_stream", [p, l_, l_, p, p, p]),
        "head_a8_probe": ("head_a8", [i, p, p, p, p, p, p, i, i, i, i, i, p]),
        "a8_depth_probe": ("a8_depth", [i, p, p, p, i, i, i, p]),
    }
    fn, args = sigs[name]
    getattr(lib, fn).argtypes = args
    getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ------------------------------------------------------------------ P1: onecall
def boundary_onecall_plain(x: torch.Tensor, w: QuantizedTensor, reps: int = 1) -> torch.Tensor:
    """``[L, D]`` f32: row ``l`` is #2's plain version on layer ``l`` (each
    rep writes the same values)."""
    return torch.stack([qmatmul_w8a16_plain(x.reshape(1, -1), w, l)[0] for l in range(w.q.shape[0])])


def strip_threads(d: int, sms: int) -> int:
    """Threads across the one-call kernel's column strip (16 columns each):
    the widest strip that still gives every SM a block, else the narrowest."""
    fits = [tc for tc in _STRIP_THREADS if d % (16 * tc) == 0]
    if not fits:
        raise ValueError(f"boundary_onecall: D={d} must be a multiple of 32")
    return next((tc for tc in fits if d // (16 * tc) >= sms), fits[-1])


def boundary_onecall(x: torch.Tensor, w: QuantizedTensor, reps: int = 1) -> torch.Tensor:
    """x f32 ``[1, N]`` (or ``[N]``) times every layer of ``w`` (int8 codes
    ``[L, N, D]``, bf16 scales ``[L, N/g, D]``), the ``L`` layers streamed
    ``reps`` times in one launch → ``[L, D]`` f32."""
    who = "boundary_onecall"
    _need(reps >= 1, who, f"reps {reps} < 1")
    if not _on_card(x, who):
        return boundary_onecall_plain(x, w, reps)
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
    xc = x.reshape(n).contiguous()
    y = torch.empty(layers, d, dtype=torch.float32, device=x.device)
    tc = strip_threads(d, _sm_count(x.device.index or 0))
    err = _lib("boundary_probe").boundary_onecall(
        xc.data_ptr(), codes.data_ptr(), scales.data_ptr(), y.data_ptr(), n, d, g, layers, reps * layers, tc,
        _stream(x))
    build.check(err, who)
    LAUNCHES["boundary_onecall"] += 1
    return y


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


def head_a8(variant: str, x: torch.Tensor, xq: torch.Tensor, xs: torch.Tensor, w: torch.Tensor,
            s: torch.Tensor, sweeps: int | None = None) -> torch.Tensor:
    """x bf16 ``[B, TN]``, xq int8 ``[B, TN]``, xs f32 ``[B, TN/64]``, w int8
    ``[n_tiles, TN, TD]``, s f32 ``[n_tiles, TN/64, TD]`` → f32 ``[B, TD]``,
    the sum over ``sweeps`` (default ``n_tiles·16``) sweeps of tile
    ``sweep % n_tiles`` of ``variant``'s product."""
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
    lib = _lib("head_a8_probe")
    out = torch.empty(b, td, dtype=torch.float32, device=x.device)
    err = lib.head_a8(HEAD_A8_VARIANTS.index(variant), x.data_ptr(), xq.data_ptr(), xs.data_ptr(), w.data_ptr(),
                      s.data_ptr(), out.data_ptr(), b, tn, td, n_tiles, sweeps, _stream(x))
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
    seg = A8_SEG_DEPTH[variant]
    acc = torch.zeros(x.shape[0], wt.shape[0], dtype=torch.float32, device=x.device)
    for k0 in range(0, x.shape[1], seg):
        acc += x[:, k0 : k0 + seg].float() @ wt[:, k0 : k0 + seg].float().T
    return acc


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
