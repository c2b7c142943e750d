"""Qwen3's forward (HF ``Qwen3ForCausalLM``) in plain PyTorch, in float32
with TF32 off, computed layer by layer so that it fits beside nothing else.

Each layer: RMSNorm, the q | k | v projection, per-head RMSNorm of q and k,
rotate-half RoPE (θ ``rope_theta``), causal attention with the kv head
``h // (n_heads / n_kv_heads)`` for query head h, scaled by 1/√head_dim, the
output projection and the residual; RMSNorm, SwiGLU (``silu(gate) · up``),
the down projection and the residual.  Then the final RMSNorm and the
classifier (the embedding's transpose when tied).  The INT8-g64 weights are
dequantized in float32 (``q · s``) one layer at a time.  Departures from the
published model: none but the weights, which are the benchmark's random
INT8 draw.

``precision="fp8"`` is the control: every activation that enters a product
(the normed stream, q, k, v, the attention output, the SwiGLU output) is
rounded to float8 e4m3 with a scale per row (its largest magnitude at 448),
the step below the bf16 activations and cache the configuration states.
"""

from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Round each row (last axis) to float8 e4m3 at a scale of its own."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _deq(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """An in-major ``[n, d]`` matrix: ``q[n, d] · s[n // g, d]``."""
    g = q.shape[0] // s.shape[0]
    return (q.float().view(s.shape[0], g, -1) * s.float()[:, None, :]).view(q.shape)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x [S, heads, hd]`` at positions ``pos [S]``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = pos.double()[:, None] * freq[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mul: int, block: int = 1024) -> torch.Tensor:
    """Causal attention: q ``[S, H, hd]``, k and v ``[S, KV, hd]`` → ``[S, H, hd]``,
    in blocks of query rows."""
    s, h, hd = q.shape
    k = k.repeat_interleave(kv_mul, dim=1).transpose(0, 1)  # [H, S, hd]
    v = v.repeat_interleave(kv_mul, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        sc = torch.matmul(q[r0:r1].transpose(0, 1), k[:, :r1].transpose(1, 2)) * scale  # [H, rows, r1]
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        sc = sc.masked_fill(torch.arange(r1, device=q.device)[None, :] > rows, float("-inf"))
        out[r0:r1] = torch.matmul(torch.softmax(sc, dim=-1), v[:, :r1]).transpose(0, 1)
    return out


def logits_at(w: dict, c, seqs: list[list[int]], rows: list[list[int]], precisions=("f32",)) -> dict:
    """Logits ``[len(rows[i]), vocab]`` (float32) of sequence ``i`` at its
    rows ``rows[i]`` (the row that predicts the next token), for each of
    ``precisions`` (``"f32"``, ``"fp8"``): ``{precision: [tensor per sequence]}``."""
    dev = w["embed_q"].device
    lp = {"f32": lambda t: t, "fp8": round_fp8}
    out = {}
    with no_tf32(), torch.no_grad():
        emb_deq = [_deq_rows(w["embed_q"][torch.as_tensor(sq, device=dev)], w["embed_s"][torch.as_tensor(sq, device=dev)])
                   for sq in seqs]
        states = {p: [e.clone() for e in emb_deq] for p in precisions}
        del emb_deq
        pos = [torch.arange(len(sq), device=dev) for sq in seqs]
        ah, kvd, hd = c.n_heads * c.head_dim, c.n_kv_heads * c.head_dim, c.head_dim
        eps, kv_mul = c.norm_eps, c.n_heads // c.n_kv_heads
        for l in range(c.n_layers):
            wqkv = _deq(w["wqkv_q"][l], w["wqkv_s"][l])
            wo = _deq(w["wo_q"][l], w["wo_s"][l])
            w13 = _deq(w["w13_q"][l], w["w13_s"][l])
            w2 = _deq(w["w2_q"][l], w["w2_s"][l])
            for p, xs in states.items():
                r = lp[p]
                for i, x in enumerate(xs):
                    s = x.shape[0]
                    qkv = r(_rms(x, w["rms_att"][l], eps)) @ wqkv
                    q = _rms(qkv[:, :ah].view(s, c.n_heads, hd), w["q_norm"][l], eps)
                    k = _rms(qkv[:, ah:ah + kvd].view(s, c.n_kv_heads, hd), w["k_norm"][l], eps)
                    v = qkv[:, ah + kvd:].view(s, c.n_kv_heads, hd)
                    q, k = _rope(q, pos[i], c.rope_theta), _rope(k, pos[i], c.rope_theta)
                    att = _attention(r(q), r(k), r(v), kv_mul).reshape(s, ah)
                    x = x + r(att) @ wo
                    gu = r(_rms(x, w["rms_ffn"][l], eps)) @ w13
                    hid = torch.nn.functional.silu(gu[:, :c.hidden_dim]) * gu[:, c.hidden_dim:]
                    xs[i] = x + r(hid) @ w2
            del wqkv, wo, w13, w2
        head = (_deq(w["lm_q"], w["lm_s"]) if "lm_q" in w
                else _deq_rows(w["embed_q"], w["embed_s"]).T)  # [dim, vocab]
        for p, xs in states.items():
            out[p] = [lp[p](_rms(x[torch.as_tensor(rw, device=dev)], w["rms_final"], eps)) @ head
                      for x, rw in zip(xs, rows)]
    return out


def _deq_rows(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Row-major rows ``[..., dim]`` with their groups along the last axis."""
    g = q.shape[-1] // s.shape[-1]
    return (q.float().view(*q.shape[:-1], s.shape[-1], g) * s.float()[..., None]).view(q.shape)
