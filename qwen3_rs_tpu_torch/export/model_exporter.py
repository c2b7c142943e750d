"""Quantized model export: HF safetensors → an INT8-g64 (or INT4) checkpoint.

* Q8_0 per-group quantization, scale ``max|w|/127`` (1.0 for an all-zero
  group), codes rounded half to even and clamped to ±127
  (``ops/quant.py::quantize_weights_np``); with ``weight_bits=4`` the linear
  layers take Q4_0 instead (±7, nibble-packed in the native layout), the
  embedding and the classifier stay Q8_0;
* the group size is fixed up front: halved until it divides ``dim``, at
  least ``MIN_GROUP_SIZE`` (``find_optimal_group_size``);
* one tensor at a time (load → LoRA merge → quantize → write), which bounds
  the memory;
* missing optional q/k norms are written as 1.0 vectors;
* a per-tensor error report: the max reconstruction error of each tensor
  beside its half-step bound.

Two formats: the native ``.qtpu`` directory (``checkpoint.py``) and the
legacy single ``.bin`` (256-byte header, the norms, then per tensor its int8
codes and f32 scales, row-major; INT8 only).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np

from ..checkpoint import IN_MAJOR_TENSORS, NativeCheckpointWriter
from ..configuration import ModelConfig
from ..ops.quant import quantize_weights_np, quantize_weights_q4_np
from ..utils.progress import ProgressTracker
from .architectures import Qwen3Architecture, create_architecture
from .config_loader import ExportModelInfo
from .lora import LoraMerger
from .tensor_reader import TensorReader

logger = logging.getLogger(__name__)

MIN_GROUP_SIZE = 4


def find_optimal_group_size(hidden_dim: int, requested: int) -> int:
    """The largest size ≤ ``requested`` reached by halving that divides
    ``hidden_dim``, at least ``MIN_GROUP_SIZE``."""
    size = min(requested, hidden_dim)
    while size >= MIN_GROUP_SIZE and hidden_dim % size != 0:
        size //= 2
    return max(size, MIN_GROUP_SIZE)


class BinaryModelExporter:
    """Streams, quantizes and writes a model's weights."""

    def __init__(self, model_info: ExportModelInfo, group_size: int, weight_bits: int = 8):
        config = model_info.config
        optimal = find_optimal_group_size(config.dim, group_size)
        if optimal != group_size:
            logger.info(
                "Adjusted group size from %d to %d to fit hidden_dim %d", group_size, optimal, config.dim
            )
        self.model_info = model_info
        self.group_size = optimal
        self.weight_bits = weight_bits
        # {tensor, layer, max_err, bound} per quantized tensor, in export order.
        self.error_report: list[dict] = []

    def export(self, model_path: Path, output_path: Path, fmt: str = "native") -> ModelConfig:
        """Write the checkpoint; returns its config (group size fixed, shared
        classifier detected)."""
        tensor_reader = TensorReader(model_path)
        config = dataclasses.replace(
            self.model_info.config, group_size=self.group_size, weight_bits=self.weight_bits
        ).validate()
        arch = create_architecture(config, tensor_reader)
        config = dataclasses.replace(config, shared_classifier=arch.detect_shared_classifier())
        lora_merger = None
        if self.model_info.is_lora:
            lora_merger = LoraMerger(tensor_reader, self.model_info.lora.lora_alpha, self.model_info.lora.r)
        if fmt == "native":
            self._export_native(config, arch, tensor_reader, lora_merger, output_path)
        elif fmt == "legacy":
            self._export_legacy(config, arch, tensor_reader, lora_merger, output_path)
        else:
            raise ValueError(f"Unknown export format: {fmt!r} (expected 'native' or 'legacy')")
        tensor_reader.clear_cache()
        return config

    def _iter_weight_tensors(self, config: ModelConfig, arch: Qwen3Architecture):
        """(HF name, component, layer, native name) in the legacy order: the
        embedding, each component over all layers, then the classifier."""
        yield arch.EMBED_TOKENS_KEY, None, None, "embed"
        for comp in arch.WEIGHT_COMPONENTS:
            for layer_idx in range(config.n_layers):
                yield (arch.layer_tensor_name(comp.hf_component, layer_idx), comp.hf_component, layer_idx,
                       comp.native_name)
        if not config.shared_classifier:
            yield arch.LM_HEAD_KEY, None, None, "lm_head"

    def _load_merged(self, tensor_reader, lora_merger, name, component, layer_idx):
        weight = tensor_reader.load_tensor(name)
        if weight is None:
            raise ValueError(f"Missing weight tensor: {name}")
        if lora_merger is not None and component is not None and layer_idx is not None:
            merged = lora_merger.try_merge(weight, component, layer_idx)
            if merged is not None:
                weight = merged
        return weight

    def _norm_entries(self, config: ModelConfig, arch: Qwen3Architecture, tensor_reader):
        """(native name, layer, f32 data) of every norm vector in the legacy
        order; missing optional ones are 1.0 vectors."""
        for spec, native_name in zip(arch.NORM_WEIGHT_LAYERS, arch.NORM_NATIVE_NAMES):
            for layer_idx in range(config.n_layers) if spec.layered else [None]:
                name = spec.name.replace("{}", str(layer_idx)) if spec.layered else spec.name
                data = tensor_reader.load_tensor(name)
                if data is None:
                    if spec.is_required:
                        raise ValueError(f"Missing weight for tensor_name: '{name}'")
                    data = np.ones(getattr(config, spec.default_len_attr), np.float32)
                yield native_name, layer_idx, data.reshape(-1).astype(np.float32)

    def _report(self, tensor: str, layer_idx, err: float, scales: np.ndarray) -> None:
        # Round to nearest is off by at most half a step of the worst group.
        self.error_report.append(
            {"tensor": tensor, "layer": layer_idx, "max_err": float(err), "bound": float(np.max(scales)) / 2.0}
        )

    def _export_native(self, config, arch, tensor_reader, lora_merger, output_path: Path):
        writer = NativeCheckpointWriter(output_path, config)
        for native_name, layer_idx, data in self._norm_entries(config, arch, tensor_reader):
            writer.write_norm(native_name, data, layer_idx)
        tensors = list(self._iter_weight_tensors(config, arch))
        progress = ProgressTracker(len(tensors), "Quantizing")
        max_error = 0.0
        for i, (name, component, layer_idx, native_name) in enumerate(tensors):
            progress.set_current(i + 1, name)
            weight = self._load_merged(tensor_reader, lora_merger, name, component, layer_idx)
            if config.weight_bits == 4 and native_name in IN_MAJOR_TENSORS:
                q, s, err = quantize_weights_q4_np(weight, self.group_size)
            else:
                q, s, err = quantize_weights_np(weight, self.group_size)
            max_error = max(max_error, err)
            self._report(native_name, layer_idx, err, s)
            writer.write_quantized(native_name, q, s, layer_idx)
        writer.close()
        progress.finish()
        logger.info(
            "Quantized %d weight tensors to Q%d_0 with max error: %.8f", len(tensors), config.weight_bits, max_error
        )
        logger.info("Written model checkpoint to %s", output_path)

    def _export_legacy(self, config, arch, tensor_reader, lora_merger, output_path: Path):
        header = config.to_legacy_header()  # refuses INT4
        with open(output_path, "wb") as f:
            f.write(header)
            for _, _, data in self._norm_entries(config, arch, tensor_reader):
                f.write(data.astype("<f4").tobytes())
            tensors = list(self._iter_weight_tensors(config, arch))
            progress = ProgressTracker(len(tensors), "Quantizing")
            max_error = 0.0
            for i, (name, component, layer_idx, _) in enumerate(tensors):
                progress.set_current(i + 1, name)
                weight = self._load_merged(tensor_reader, lora_merger, name, component, layer_idx)
                q, s, err = quantize_weights_np(weight.reshape(-1), self.group_size)
                max_error = max(max_error, err)
                self._report(name, layer_idx, err, s)
                f.write(q.astype(np.int8).tobytes())  # all codes, then all scales
                f.write(s.astype("<f4").tobytes())
            progress.finish()
        logger.info("Quantized %d weight tensors to Q8_0 with max error: %.8f", len(tensors), max_error)
        logger.info("Written model checkpoint to %s", output_path)
