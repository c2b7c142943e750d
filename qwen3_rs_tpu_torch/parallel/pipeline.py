"""Pipeline parallelism: GPipe-style layer stages for inference.

The port of the reference package's ``parallel/pipeline.py``.  Each rank of a
``pp`` mesh of P ranks (one process a rank, ``parallel.distributed.launch``)
is a stage: it keeps a contiguous slab of ``n_layers / P`` layers and its slab
of the dense KV cache; the embedding, the final norm and the classifier are
replicated.  Every rank calls ``pipelined_forward`` with the same arguments
(SPMD).  The batch splits into M microbatches that flow through the stages:
at tick t stage s runs microbatch t - s, then hands its activations to stage
s + 1 (one ``ops.collectives.exchange`` a tick: each stage's send and
receive posted together, ``dist.batch_isend_irecv``).  A forward is
M + P - 1 ticks.  Bubble ticks compute on the clamped microbatch and write
nothing, so every stage runs the same program; the last stage's finished
microbatches are summed over the ranks (``all_reduce``: every other rank
adds zeros, so the sum is exact) and every rank runs the classifier.

As in the reference, the layer math is that of ``models/qwen3.py``'s layer
body through ``_project`` for every projection (fast mode: the W8A16 kernel
up to 256 rows, the dense product above) and the plain split attention; no
window takes the causal prefill kernel, flash decode, the row-blocked
kernel, the megakernel or the fused glue.  The pipeline is an API of its own
(no CLI flag), not wired into serving, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configuration import ModelConfig
from ..device import resolve_device
from ..models.qwen3 import KVCache, Qwen3Weights, _embed, _project, _write_rows
from ..ops.attention import gqa_attention_split
from ..ops.collectives import all_reduce, exchange
from ..ops.norms import rms_norm
from ..ops.quant import quantize_activations
from ..ops.rope import apply_rope, rope_table
from .mesh import PP_AXIS, Mesh, create_mesh
from .sharding import Split, shard_tree


def create_pp_mesh(pp: int | None = None, devices=None) -> Mesh:
    """This rank's mesh on the ``pp`` axis over ``devices`` (default: every
    visible card), cut to the first ``pp`` of them; adjacent stages are
    adjacent ranks.  More than one device needs the process group of that
    many ranks (``parallel.distributed.launch(..., axis="pp")``)."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or [resolve_device(None)]
    devices = list(devices)
    if pp is not None:
        if pp > len(devices):
            raise ValueError(f"pp={pp} exceeds the {len(devices)} available devices")
        devices = devices[:pp]
    return create_mesh(devices=devices, pp=len(devices))


def validate_pp(config: ModelConfig, pp: int, batch: int, n_microbatches: int):
    if config.n_layers % pp:
        raise ValueError(f"n_layers ({config.n_layers}) must divide over pp={pp}")
    if batch % n_microbatches:
        raise ValueError(f"batch ({batch}) must divide into {n_microbatches} microbatches")


def pp_weight_pspecs(weights: Qwen3Weights) -> Qwen3Weights:
    """The rule of every tensor of ``weights`` for the pipeline: each
    layer-stacked tensor split on its leading (layer) axis over ``pp``
    (``Split(0, "pp")``), the embedding, the final norm and the classifier
    replicated (None)."""
    lw = weights.layers
    cut = Split(0, PP_AXIS)
    layers = type(lw)(*((type(t)(cut, cut) if hasattr(t, "scales") else cut) for t in lw))
    return Qwen3Weights(embed=None, layers=layers, rms_final=None, lm_head=None)


def _cache_pspecs(cache) -> KVCache:
    return type(cache)(*(Split(0, PP_AXIS) for _ in cache))


def shard_for_pp(weights: Qwen3Weights, cache, mesh: Mesh):
    """This rank's weights and cache for the pipeline, on its device: its
    slab of every layer-stacked tensor and of the cache (each a tensor of its
    own), the rest as given."""
    dev, parts = mesh.device, mesh.parts()

    def to(tree):
        return type(tree)(*(to(t) if isinstance(t, tuple) else t.to(dev) for t in tree))

    w = to(shard_tree(weights, pp_weight_pspecs(weights), parts))
    return w, to(shard_tree(cache, _cache_pspecs(cache), parts))


def _slab_of(tree, n_layers: int, pp: int, rank: int):
    """This stage's slab of a layer-stacked tree given whole (views: writes to
    the slab reach the whole tree), or the tree if it is a slab already."""
    first = tree[0] if not isinstance(tree[0], tuple) else tree[0][0]
    if pp == 1 or first.shape[0] != n_layers:
        return tree
    n = n_layers // pp

    def cut(t):
        return type(t)(*(cut(u) for u in t)) if isinstance(t, tuple) else t.narrow(0, rank * n, n)

    return cut(tree)


def _layer(w, l: int):
    return type(w)(w.q[l], w.scales[l])


def _slab_forward(config: ModelConfig, lw, x, cache, pos_mb: np.ndarray, cos, sin, mode: str, write: bool):
    """This stage's layer slab on one microbatch: ``x`` ``[mb, S, dim]`` in
    the stream's dtype, ``cache`` this stage's cache rows of the microbatch
    (views of ``[L_loc, mb, kv, T, hd]``), written in place when ``write``."""
    b, s = x.shape[:2]
    cd = x.dtype
    c = config
    eps, g = c.norm_eps, c.group_size
    ah, kvd, hd = c.all_heads_dim, c.kv_dim, c.head_dim

    def quant(t):
        return quantize_activations(t, g) if mode == "exact" else None

    for l in range(lw.rms_att.shape[0]):
        xn = rms_norm(x, lw.rms_att[l], eps)
        qkv = _project(xn, quant(xn), _layer(lw.wqkv, l), mode)
        q = qkv[..., :ah].reshape(b, s, c.n_heads, hd)
        k = qkv[..., ah : ah + kvd].reshape(b, s, c.n_kv_heads, hd)
        v = qkv[..., ah + kvd :].reshape(b, s, c.n_kv_heads, hd)
        if c.use_qk_norm:
            q = rms_norm(q, lw.q_norm[l], eps)
            k = rms_norm(k, lw.k_norm[l], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        att = gqa_attention_split(q.to(cd), cache.k[l], cache.v[l], k.to(cd), v.to(cd), pos_mb)
        if write:
            _write_rows(cache, l, k, v, pos_mb, None)
        att = att.reshape(b, s, ah)
        x = x + _project(att, quant(att), _layer(lw.wo, l), mode).to(cd)
        xn = rms_norm(x, lw.rms_ffn[l], eps)
        gate_up = _project(xn, quant(xn), _layer(lw.w13, l), mode)
        gate, up = gate_up[..., : c.hidden_dim], gate_up[..., c.hidden_dim :]
        h = (gate * torch.sigmoid(gate) * up).to(cd)
        x = x + _project(h, quant(h), _layer(lw.w2, l), mode).to(cd)
    return x


def pipelined_forward(
    config: ModelConfig,
    weights: Qwen3Weights,
    tokens,  # [B, S] ints, the same on every rank
    cache: KVCache,
    pos_start,  # [B] host ints
    mesh: Mesh,
    *,
    n_microbatches: int | None = None,
    mode: str = "fast",
    return_all_logits: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """One model step through the layer pipeline, called on every rank of
    ``mesh``; the contract of the dense-cache ``qwen3_forward``: returns
    (logits ``[B, vocab_size]`` f32, or ``[B, S, vocab_size]`` with
    ``return_all_logits``, the same on every rank; this rank's cache slab,
    updated in place).

    ``weights`` and ``cache`` may be this rank's slabs (``shard_for_pp``) or
    whole: a whole tree is cut to this stage's slab (views, so a whole cache
    is updated in place).  In fast mode on the card the W8A16 kernel takes
    bf16 scales, as the fast engine keeps them (``cast_weight_scales``).
    ``n_microbatches`` defaults to ``min(pp, B)``.
    """
    pp, stage = mesh.shape[PP_AXIS], mesh.rank
    tokens_np = np.asarray(tokens, np.int64)
    b, s = tokens_np.shape
    m = n_microbatches or min(pp, b)
    validate_pp(config, pp, b, m)
    if hasattr(cache, "k_scale"):
        raise ValueError("the pipeline takes a dense bf16/f32 cache (KVCache), as the reference's does")
    mbs = b // m
    weights = weights._replace(layers=_slab_of(weights.layers, config.n_layers, pp, stage))
    cache = _slab_of(cache, config.n_layers, pp, stage)
    lw = weights.layers
    dev = weights.embed.q.device
    cd = torch.float32 if mode == "exact" else torch.bfloat16  # the residual stream's dtype, as qwen3_forward's
    pos = np.asarray(torch.as_tensor(pos_start).cpu(), np.int64).reshape(b)
    tokens = torch.as_tensor(tokens_np, device=dev)
    rope_len = cache.seq_len
    cos_t, sin_t = rope_table(rope_len, config.head_dim, config.rope_theta, dev)
    x_in = torch.zeros(mbs, s, config.dim, dtype=cd, device=dev)
    out_buf = torch.zeros(b, s, config.dim, dtype=cd, device=dev)
    for t in range(m + pp - 1):
        mb = t - stage
        valid = 0 <= mb < m
        off = min(max(mb, 0), m - 1) * mbs
        # Stage 0 takes a fresh microbatch from the embedding; later stages the
        # activations the stage before sent at the previous tick.
        x = _embed(weights, tokens[off : off + mbs], None).to(cd) if stage == 0 else x_in
        pos_mb = pos[off : off + mbs]
        q_pos = torch.as_tensor(np.minimum(pos_mb[:, None] + np.arange(s), rope_len - 1), device=dev)
        cos, sin = cos_t[q_pos][:, :, None, :], sin_t[q_pos][:, :, None, :]
        rows = type(cache)(*(c_[:, off : off + mbs] for c_ in cache))
        x = _slab_forward(config, lw, x, rows, pos_mb, cos, sin, mode, write=valid)
        if valid and stage == pp - 1:
            out_buf[off : off + mbs] = x
        if pp > 1:
            got = exchange([(x, stage + 1)] if stage < pp - 1 else [],
                           [(x.shape, x.dtype, stage - 1)] if stage > 0 else [], mesh.group, dev)
            x_in = got[0] if got else x_in
    # Only the last stage wrote its buffer: the sum over the ranks is its rows.
    hidden = out_buf if pp == 1 else all_reduce(out_buf.float(), mesh.group).to(cd)
    if not return_all_logits:
        hidden = hidden[:, -1:]
    xn = rms_norm(hidden, weights.rms_final, config.norm_eps)
    xq = quantize_activations(xn, config.group_size) if mode == "exact" else None
    logits = _project(xn, xq, weights.lm_head, mode).float()[..., : config.vocab_size]
    if not return_all_logits:
        logits = logits[:, 0]
    return logits, cache
