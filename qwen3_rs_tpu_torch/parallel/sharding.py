"""Sharding rules: which part of each weight and cache tensor a rank holds.

The port of the reference package's ``parallel/sharding.py``.  Its
PartitionSpecs become ``Split`` rules (a tensor cut into equal parts along
one axis, one part per index of a mesh axis, by default tp; a rank keeps the
part at its own index) and ``None`` (replicated), applied per rank:

* column-parallel (the out axis): wqkv, w13 and lm_head (its padded vocab
  columns);
* row-parallel (the in axis): wo and w2, their scales' group axis split
  alike, so each rank's groups stay whole (``validate_tp``);
* the embedding on its vocab rows;
* norms replicated;
* the KV cache on its batch axis over dp and its kv-head axis over tp, so
  attention stays local to a rank;
* tokens and logits on their batch axis over dp (``token_spec``,
  ``logits_spec``).

INT4 codes are nibble-packed within a group along the in axis, and the
row-parallel cut falls on group boundaries, so the packed codes split like
INT8 ones.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configuration import ModelConfig
from ..models.qwen3 import KVCache, Qwen3LayerWeights, Qwen3Weights
from ..ops.quant import QuantizedTensor
from .mesh import DP_AXIS, TP_AXIS


@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor cut into equal parts along ``axis``, one part per index of
    the mesh axis ``over``."""

    axis: int
    over: str = TP_AXIS

    def take(self, t: torch.Tensor, n: int, index: int) -> torch.Tensor:
        """Part ``index`` of ``n`` of ``t``, as a tensor of its own (the rest
        can be freed)."""
        size = t.shape[self.axis]
        if size % n:
            raise ValueError(f"{self.over}={n} does not divide axis {self.axis} of a tensor of shape {tuple(t.shape)}")
        w = size // n
        return t.narrow(self.axis, index * w, w).contiguous()


@dataclasses.dataclass(frozen=True)
class Splits:
    """Cuts of one tensor along several axes, applied in order (a
    PartitionSpec that names more than one mesh axis)."""

    splits: tuple[Split, ...]


def validate_tp(config: ModelConfig, tp: int) -> None:
    """Check that a tp degree is compatible with the model's shapes."""
    if config.n_kv_heads % tp and tp % config.n_kv_heads:
        raise ValueError(
            f"tp={tp} incompatible with n_kv_heads={config.n_kv_heads}: one must divide the other"
        )
    if config.n_heads % tp:
        raise ValueError(f"tp={tp} must divide n_heads={config.n_heads}")
    for name, out_dim in (
        ("hidden_dim", config.hidden_dim),
        ("all_heads_dim", config.all_heads_dim),
    ):
        if out_dim % tp:
            raise ValueError(f"tp={tp} must divide {name}={out_dim}")
    for name, in_dim in (
        ("all_heads_dim", config.all_heads_dim),
        ("hidden_dim", config.hidden_dim),
    ):
        shard = in_dim // tp
        if shard % config.group_size:
            raise ValueError(
                f"tp={tp} shards {name}={in_dim} into {shard}, which breaks "
                f"group_size={config.group_size} alignment"
            )


def _qt_spec(rule) -> QuantizedTensor:
    """Scales follow the codes (the group axis stands in for the in axis)."""
    return QuantizedTensor(rule, rule)


def weight_pspecs(config: ModelConfig) -> Qwen3Weights:
    """The rule of every tensor of ``Qwen3Weights`` (in-major layout: codes
    [L, in, out], scales [L, in/g, out]); ``None`` is replicated."""
    col = _qt_spec(Split(-1))  # the out axis
    row = _qt_spec(Split(-2))  # the in (contraction) axis
    layers = Qwen3LayerWeights(
        rms_att=None, rms_ffn=None, q_norm=None, k_norm=None, wqkv=col, wo=row, w13=col, w2=row
    )
    return Qwen3Weights(embed=_qt_spec(Split(0)), layers=layers, rms_final=None, lm_head=col)


_CACHE_SPEC = Splits((Split(1, DP_AXIS), Split(2)))


def cache_pspecs() -> KVCache:
    """[L, B(dp), n_kv(tp), T, head_dim]."""
    return KVCache(_CACHE_SPEC, _CACHE_SPEC)


def logits_spec() -> Split:
    """Logits ``[B(dp), vocab]``."""
    return Split(0, DP_AXIS)


def token_spec() -> Split:
    """Tokens ``[B(dp), S]``."""
    return Split(0, DP_AXIS)


def shard_tree(tree, specs, parts: dict):
    """This rank's part of each tensor of ``tree`` (a tensor, or nested
    NamedTuples: weights, a linear layer of either code format, a cache)
    under the rules ``specs`` of the same structure; ``parts`` gives each
    mesh axis as ``(size, this rank's index)`` (``Mesh.parts()``)."""
    if specs is None:
        return tree
    if isinstance(specs, Split):
        return specs.take(tree, *parts.get(specs.over, (1, 0)))
    if isinstance(specs, Splits):
        for split in specs.splits:
            tree = shard_tree(tree, split, parts)
        return tree
    return type(tree)(*(shard_tree(t, s, parts) for t, s in zip(tree, specs, strict=True)))


def shard_weights(weights: Qwen3Weights, mesh, config: ModelConfig) -> Qwen3Weights:
    """This rank's part of the weights under ``weight_pspecs`` (no column
    interleave: ``parallel.tp.shard_weights_tp`` is the forward's)."""
    validate_tp(config, mesh.tp)
    return shard_tree(weights, weight_pspecs(config), mesh.parts())


def shard_cache(cache, mesh):
    """This rank's rows and kv heads of a cache: every leaf (K, V and an
    INT8 cache's scales; dense or paged) splits its axis 1 (the batch, or a
    pool's pages) over dp and its kv-head axis, axis 2, over tp."""
    return shard_tree(cache, type(cache)(*(_CACHE_SPEC for _ in cache)), mesh.parts())
