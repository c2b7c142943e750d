from .qwen3 import (
    KVCache,
    QuantizedKVCache,
    Qwen3LayerWeights,
    Qwen3Weights,
    init_kv_cache,
    qwen3_forward,
    weights_from_jax_numpy,
)

__all__ = [
    "KVCache",
    "QuantizedKVCache",
    "Qwen3LayerWeights",
    "Qwen3Weights",
    "init_kv_cache",
    "qwen3_forward",
    "weights_from_jax_numpy",
]
