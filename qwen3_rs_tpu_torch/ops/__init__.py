"""Tensor operations of the port: plain PyTorch ops and the kernel wrappers
under ``ops/kernels``; the names the reference package's ``ops`` exports."""
from .attention import gqa_attention
from .matmul import qmatmul, qmatmul_exact
from .norms import rms_norm
from .quant import (
    QuantizedTensor,
    dequantize,
    dequantize_np,
    quantize_activations,
    quantize_weights,
    quantize_weights_np,
)
from .rope import apply_rope, rope_table
from .sampling import Sampler, XorshiftRng, sample_tokens, softmax_f32

# The reference's name for the batched device sampler.
sample_tokens_jax = sample_tokens

__all__ = [
    "QuantizedTensor",
    "quantize_activations",
    "quantize_weights",
    "quantize_weights_np",
    "dequantize",
    "dequantize_np",
    "qmatmul",
    "qmatmul_exact",
    "rms_norm",
    "apply_rope",
    "rope_table",
    "gqa_attention",
    "Sampler",
    "XorshiftRng",
    "sample_tokens",
    "sample_tokens_jax",
    "softmax_f32",
]
