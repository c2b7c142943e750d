"""LoRA adapter merging before quantization: ``W = W_base + (alpha/r)·(B @ A)``."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .tensor_reader import TensorReader

logger = logging.getLogger(__name__)


class LoraMerger:
    def __init__(self, tensor_reader: TensorReader, alpha: float, rank: int):
        scaling = alpha / rank
        if not np.isfinite(scaling):
            raise ValueError(
                f"Invalid scaling factor: {scaling} (must be finite). "
                f"Alpha: {alpha}, Rank: {rank}"
            )
        self.tensor_reader = tensor_reader
        self.scaling = float(scaling)
        self.rank = int(rank)

    def try_merge(self, base_weights: np.ndarray, component: str, layer_idx: int) -> Optional[np.ndarray]:
        """The merged tensor where an adapter pair
        ``base_model.model.model.layers.{i}.{component}.lora_{A,B}.weight``
        exists, else None."""
        prefix = f"base_model.model.model.layers.{layer_idx}.{component}"
        lora_a = self.tensor_reader.load_tensor(f"{prefix}.lora_A.weight")
        lora_b = self.tensor_reader.load_tensor(f"{prefix}.lora_B.weight")
        if lora_a is None or lora_b is None:
            return None
        return self.merge(base_weights, lora_a, lora_b)

    def merge(self, base: np.ndarray, lora_a: np.ndarray, lora_b: np.ndarray) -> np.ndarray:
        """``W = W_base + scaling·(B @ A)`` in f32, with A ``(r, in)`` and B
        ``(out, r)``; their widths follow from the rank and must match the
        base tensor."""
        if base.size == 0 or lora_a.size == 0 or lora_b.size == 0:
            raise ValueError(
                f"Empty tensors not allowed: base={base.size}, A={lora_a.size}, B={lora_b.size}"
            )
        if lora_a.size % self.rank != 0:
            raise ValueError(
                f"LoRA A tensor size ({lora_a.size}) is not divisible by rank ({self.rank})"
            )
        if lora_b.size % self.rank != 0:
            raise ValueError(
                f"LoRA B tensor size ({lora_b.size}) is not divisible by rank ({self.rank})"
            )
        in_features = lora_a.size // self.rank
        out_features = lora_b.size // self.rank
        if in_features * out_features != base.size:
            raise ValueError(
                f"Dimension mismatch: base tensor size ({base.size}) doesn't match "
                f"calculated dimensions ({out_features}×{in_features})"
            )
        if abs(self.scaling) > 1e3:
            logger.warning("Large scaling factor detected: %.6f", self.scaling)

        a = lora_a.reshape(self.rank, in_features).astype(np.float32)
        b = lora_b.reshape(out_features, self.rank).astype(np.float32)
        delta = (b @ a) * np.float32(self.scaling)
        result = base.reshape(out_features, in_features).astype(np.float32) + delta
        if not np.all(np.isfinite(result)):
            raise ValueError("Non-finite value detected in LoRA merge result")
        abs_delta = np.abs(delta)
        avg_base = float(np.abs(base).mean()) if base.size else 0.0
        logger.debug(
            "LoRA merge complete: max_delta=%.6f avg_delta=%.6f relative_change=%.3f%%",
            float(abs_delta.max()),
            float(abs_delta.mean()),
            (float(abs_delta.mean()) / avg_base * 100.0) if avg_base > 1e-12 else 0.0,
        )
        return result.reshape(base.shape)
