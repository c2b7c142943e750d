"""Per-architecture tensor-name schedules: the HF names of the norm weights
and of the quantized components, in the legacy file's order, and the
shared-classifier test."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..configuration import ARCHITECTURE_LLAMA, ARCHITECTURE_QWEN3, ModelConfig
from .tensor_reader import TensorReader


@dataclasses.dataclass(frozen=True)
class NormWeightLayer:
    """One norm-weight entry: ``name`` may hold a ``{}`` layer placeholder;
    a missing optional entry is written as a 1.0 vector of
    ``config.<default_len_attr>`` elements."""

    name: str
    layered: bool
    is_required: bool
    default_len_attr: str = "head_dim"


@dataclasses.dataclass(frozen=True)
class WeightComponent:
    """One quantized component: its HF name (no ``.weight``) and its native name."""

    hf_component: str
    native_name: str


class Qwen3Architecture:
    ID = ARCHITECTURE_QWEN3
    NAME = "Qwen3ForCausalLM"
    EMBED_TOKENS_KEY = "model.embed_tokens.weight"
    LM_HEAD_KEY = "lm_head.weight"

    # The legacy file's norm-section order.
    NORM_WEIGHT_LAYERS = (
        NormWeightLayer("model.layers.{}.input_layernorm.weight", True, True),
        NormWeightLayer("model.layers.{}.post_attention_layernorm.weight", True, True),
        NormWeightLayer("model.norm.weight", False, True),
        NormWeightLayer("model.layers.{}.self_attn.q_norm.weight", True, False),
        NormWeightLayer("model.layers.{}.self_attn.k_norm.weight", True, False),
    )
    NORM_NATIVE_NAMES = ("rms_att", "rms_ffn", "rms_final", "q_norm", "k_norm")

    # The legacy file's component order (each over all layers).
    WEIGHT_COMPONENTS = (
        WeightComponent("self_attn.q_proj", "wq"),
        WeightComponent("self_attn.k_proj", "wk"),
        WeightComponent("self_attn.v_proj", "wv"),
        WeightComponent("self_attn.o_proj", "wo"),
        WeightComponent("mlp.gate_proj", "w1"),
        WeightComponent("mlp.down_proj", "w2"),
        WeightComponent("mlp.up_proj", "w3"),
    )

    def __init__(self, config: ModelConfig, tensor_reader: TensorReader):
        self.config = config
        self.tensor_reader = tensor_reader

    def layer_tensor_name(self, component: str, layer_idx: int) -> str:
        return f"model.layers.{layer_idx}.{component}.weight"

    def detect_shared_classifier(self) -> bool:
        """Shared when ``lm_head`` is absent, or equal to the embedding within
        1e-6 elementwise."""
        lm_head = self.tensor_reader.load_tensor(self.LM_HEAD_KEY)
        embed = self.tensor_reader.load_tensor(self.EMBED_TOKENS_KEY)
        if lm_head is None and embed is not None:
            return True
        if lm_head is None or embed is None:
            return False
        return lm_head.size == embed.size and bool(
            np.all(np.abs(lm_head.reshape(-1) - embed.reshape(-1)) < 1e-6)
        )


class LlamaArchitecture(Qwen3Architecture):
    """Llama: the Qwen3 names without q/k norms (written as 1.0 vectors;
    ``config.use_qk_norm`` is False)."""

    ID = ARCHITECTURE_LLAMA
    NAME = "LlamaForCausalLM"


ARCHITECTURES = {
    ARCHITECTURE_QWEN3: Qwen3Architecture,
    ARCHITECTURE_LLAMA: LlamaArchitecture,
}


def create_architecture(config: ModelConfig, tensor_reader: TensorReader):
    cls = ARCHITECTURES.get(config.architecture_id)
    if cls is None:
        raise NotImplementedError(f"Architecture id {config.architecture_id} not yet implemented")
    return cls(config, tensor_reader)
