"""Parallel layouts on ``torch.distributed``, one process a rank: the (dp,
tp) mesh and its process subgroups, tensor parallelism (the sharding rules
and the tensor-parallel forward), the GPipe pipeline (``pipeline.py``), ring
attention for the sequence-parallel prefill (``context.py``) and the
scaling harness (``distributed.scaling_report``)."""

from .context import SP_AXIS, ring_prefill_attention, ring_prefill_attention_inner
from .distributed import initialize_distributed, launch, scaling_report
from .mesh import DP_AXIS, PP_AXIS, TP_AXIS, Mesh, create_mesh, single_device_mesh
from .pipeline import create_pp_mesh, pipelined_forward, pp_weight_pspecs, shard_for_pp, validate_pp
from .sharding import (
    Split,
    Splits,
    cache_pspecs,
    logits_spec,
    shard_cache,
    shard_weights,
    token_spec,
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
    "Splits",
    "weight_pspecs",
    "cache_pspecs",
    "logits_spec",
    "token_spec",
    "shard_weights",
    "shard_cache",
    "validate_tp",
    "initialize_distributed",
    "launch",
    "scaling_report",
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
