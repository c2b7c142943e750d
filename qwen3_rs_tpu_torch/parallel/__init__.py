"""Tensor parallelism on ``torch.distributed``: the mesh, the sharding rules,
process groups and the tensor-parallel forward.  Pipeline and sequence
parallelism are not ported yet (``qwen3_rs_tpu_torch.NOT_PORTED``)."""

from .distributed import initialize_distributed, launch
from .mesh import DP_AXIS, TP_AXIS, Mesh, create_mesh, single_device_mesh
from .sharding import (
    Split,
    cache_pspecs,
    shard_cache,
    shard_weights,
    validate_tp,
    weight_pspecs,
)
from .tp import interleave_for_tp, local_config, make_tp_forward, shard_cache_tp, shard_weights_tp

__all__ = [
    "DP_AXIS",
    "TP_AXIS",
    "Mesh",
    "create_mesh",
    "single_device_mesh",
    "Split",
    "weight_pspecs",
    "cache_pspecs",
    "shard_weights",
    "shard_cache",
    "validate_tp",
    "initialize_distributed",
    "launch",
    "local_config",
    "interleave_for_tp",
    "shard_weights_tp",
    "shard_cache_tp",
    "make_tp_forward",
]
