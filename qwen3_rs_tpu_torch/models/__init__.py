"""Model registry: architecture id → forward implementation, as the
reference package's."""

from __future__ import annotations

from ..configuration import ARCHITECTURE_LLAMA, ARCHITECTURE_QWEN3, ModelConfig
from .qwen3 import (
    KVCache,
    QuantizedKVCache,
    Qwen3LayerWeights,
    Qwen3Weights,
    init_kv_cache,
    qwen3_forward,
    weights_from_jax_numpy,
)

MODEL_FORWARDS = {
    ARCHITECTURE_QWEN3: qwen3_forward,
    # Llama shares the decoder structure; its config turns QK-norm off.
    ARCHITECTURE_LLAMA: qwen3_forward,
}


def get_forward(config: ModelConfig):
    fwd = MODEL_FORWARDS.get(config.architecture_id)
    if fwd is None:
        raise ValueError(f"Unknown architecture_id: {config.architecture_id}")
    return fwd


__all__ = [
    "KVCache",
    "QuantizedKVCache",
    "Qwen3LayerWeights",
    "Qwen3Weights",
    "init_kv_cache",
    "qwen3_forward",
    "weights_from_jax_numpy",
    "get_forward",
    "MODEL_FORWARDS",
]
