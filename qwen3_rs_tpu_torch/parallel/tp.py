"""Tensor parallelism: the forward of one rank over its weight and cache
shards, with explicit collectives.

The port of the reference package's ``parallel/tp.py``, which runs its
``qwen3_forward`` inside ``shard_map``.  Here every rank runs the same
``qwen3_forward`` on its own shard (``tp_group``): the kernels see local
tensors with ordinary shapes and engage exactly as on one device, and the
communication is Megatron's column→row parallelism, one all-reduce after
each row-parallel projection (wo, w2) and one after the vocab-sharded
embedding gather, plus the all-gather of the classifier's vocab columns.

The fused ``wqkv = [q|k|v]`` and ``w13 = [gate|up]`` projections concatenate
on the out axis, so plain column chunking would not align the q/k/v
(gate/up) splits with the shards.  ``interleave_for_tp`` permutes their out
columns so that shard t holds ``[q_t | k_t | v_t]`` (``[gate_t | up_t]``);
the forward then splits with the local dims of ``local_config``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configuration import ModelConfig
from ..models.qwen3 import Qwen3Weights, qwen3_forward
from .mesh import TP_AXIS
from .sharding import shard_cache, shard_tree, validate_tp, weight_pspecs


def local_config(config: ModelConfig, tp: int) -> ModelConfig:
    """Per-shard dims: heads, kv heads and hidden divide by tp; everything
    positional (dim, head_dim, seq_len, rope) and the vocabulary stay
    global."""
    return dataclasses.replace(
        config,
        n_heads=config.n_heads // tp,
        n_kv_heads=config.n_kv_heads // tp,
        hidden_dim=config.hidden_dim // tp,
    )


def _interleave_index(parts: list[int], tp: int) -> np.ndarray:
    """The out-column permutation under which shard t holds
    [part0_t | part1_t | ...]."""
    idx = []
    offs = np.cumsum([0] + parts[:-1])
    for t in range(tp):
        for off, size in zip(offs, parts):
            w = size // tp
            idx.extend(range(off + t * w, off + (t + 1) * w))
    return np.asarray(idx, np.int64)


def _take_cols(qt, idx: np.ndarray):
    i = torch.as_tensor(idx, device=qt.q.device)
    return type(qt)(torch.index_select(qt.q, -1, i), torch.index_select(qt.scales, -1, i))


def _interleave_cols(qt, parts: list[int], tp: int):
    """Permute the out (last) axis of a stacked (codes, scales) tensor so
    that shard t holds [part0_t | part1_t | ...]."""
    return _take_cols(qt, _interleave_index(parts, tp))


def _fused_parts(config: ModelConfig) -> dict[str, list[int]]:
    ah, kvd = config.all_heads_dim, config.kv_dim
    return {"wqkv": [ah, kvd, kvd], "w13": [config.hidden_dim, config.hidden_dim]}


def interleave_for_tp(weights: Qwen3Weights, config: ModelConfig, tp: int) -> Qwen3Weights:
    """One-time column permutation of wqkv / w13 for shard-aligned splits."""
    if tp == 1:
        return weights
    lw = weights.layers
    parts = _fused_parts(config)
    return weights._replace(layers=lw._replace(
        wqkv=_interleave_cols(lw.wqkv, parts["wqkv"], tp), w13=_interleave_cols(lw.w13, parts["w13"], tp),
    ))


def shard_weights_tp(weights: Qwen3Weights, mesh, config: ModelConfig) -> Qwen3Weights:
    """This rank's shard for the tensor-parallel forward: the interleaved
    wqkv / w13 columns of this rank (taken directly, without interleaving the
    whole matrices first) and every other tensor under ``weight_pspecs``.
    Each shard is a tensor of its own, so the full weights can be freed."""
    tp, rank = mesh.tp, mesh.tp_index
    validate_tp(config, tp)
    specs = weight_pspecs(config)
    lw = weights.layers
    fused = {}
    for name, parts in _fused_parts(config).items():
        idx = _interleave_index(parts, tp)
        w = len(idx) // tp
        fused[name] = _take_cols(getattr(lw, name), idx[rank * w : (rank + 1) * w])
    rest = weights._replace(layers=lw._replace(wqkv=None, w13=None))
    specs = specs._replace(layers=specs.layers._replace(wqkv=None, w13=None))
    out = shard_tree(rest, specs, mesh.parts())
    return out._replace(layers=out.layers._replace(**fused))


# The forward's cache shards: every leaf of a dense cache ``[L, B, n_kv, T,
# hd]``, a page pool ``[L, P, n_kv, page, hd]`` and their INT8 scale
# companions splits its kv-head axis (axis 2) over tp, and axis 1 over dp, as
# ``shard_cache`` does.
shard_cache_tp = shard_cache


def make_tp_forward(config: ModelConfig, mesh, *, mode: str = "fast"):
    """A ``qwen3_forward``-shaped callable for this rank: weights from
    :func:`shard_weights_tp`, the cache from :func:`shard_cache_tp` (or built
    with ``local_config``), and global logits ``[..., vocab_size]``, the same
    on every rank of its replica, with the cache updated in place.  Its
    collectives run over the replica's ranks (``mesh.tp_group``)."""
    tp = mesh.shape[TP_AXIS]
    validate_tp(config, tp)
    config_l = local_config(config, tp)

    def tp_forward(weights, tokens, cache, pos_start, *, return_all_logits: bool = False, out_idx=None,
                   write_mask=None, page_table=None, fresh_prefill: bool = False):
        return qwen3_forward(config_l, weights, tokens, cache, pos_start, mode=mode, out_idx=out_idx,
                             return_all_logits=return_all_logits, fresh_prefill=fresh_prefill,
                             page_table=page_table, write_mask=write_mask, tp_group=mesh.tp_group)

    return tp_forward
