"""Parallel layouts on ``torch.distributed``, one process a rank: the mesh,
tensor parallelism (the sharding rules, process groups and the
tensor-parallel forward), the GPipe pipeline (``pipeline.py``) and ring
attention for the sequence-parallel prefill (``context.py``)."""

from .context import SP_AXIS, ring_prefill_attention, ring_prefill_attention_inner
from .distributed import initialize_distributed, launch
from .mesh import DP_AXIS, PP_AXIS, TP_AXIS, Mesh, create_mesh, single_device_mesh
from .pipeline import create_pp_mesh, pipelined_forward, pp_weight_pspecs, shard_for_pp, validate_pp
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
    "SP_AXIS",
    "PP_AXIS",
    "Mesh",
    "create_mesh",
    "create_pp_mesh",
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
    "ring_prefill_attention",
    "ring_prefill_attention_inner",
    "pipelined_forward",
    "shard_for_pp",
    "validate_pp",
    "pp_weight_pspecs",
]
