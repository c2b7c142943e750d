"""HF ``config.json`` → ``ModelConfig``, and LoRA detection: a model
directory with ``adapter_config.json`` is a LoRA fine-tune whose adapters are
merged at export."""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional

from ..configuration import ARCHITECTURE_LLAMA, ARCHITECTURE_NAMES, ModelConfig

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class LoRAConfig:
    """The fields of ``adapter_config.json`` the exporter reads."""

    lora_alpha: float
    r: int
    target_modules: list[str]
    base_model_name_or_path: Optional[str] = None


@dataclasses.dataclass
class ExportModelInfo:
    """Model config, optional LoRA config and the special token ids."""

    config: ModelConfig
    lora: Optional[LoRAConfig]
    bos_token_id: int
    eos_token_id: int

    @property
    def is_lora(self) -> bool:
        return self.lora is not None


def load_model_info(model_path: str | Path) -> ExportModelInfo:
    """Read the model directory's configuration (and adapter config)."""
    model_path = Path(model_path)
    has_adapter = (model_path / "adapter_config.json").exists()
    has_base = (model_path / "config.json").exists()

    if not has_base and has_adapter:
        raise FileNotFoundError(
            f"Only LoRA config is found in {model_path}. Make sure to have base "
            "model files in the same directory"
        )
    if not has_base:
        raise FileNotFoundError(f"No valid configuration files found in {model_path}")

    lora = _load_lora_config(model_path) if has_adapter else None
    config, bos, eos = _load_hf_config(model_path / "config.json")
    if lora is not None:
        logger.info(
            "Detected LoRA model: alpha=%s r=%s targets=%s", lora.lora_alpha, lora.r, lora.target_modules
        )
    return ExportModelInfo(config=config, lora=lora, bos_token_id=bos, eos_token_id=eos)


def _load_lora_config(model_path: Path) -> LoRAConfig:
    payload = json.loads((model_path / "adapter_config.json").read_text())
    try:
        return LoRAConfig(
            lora_alpha=float(payload["lora_alpha"]),
            r=int(payload["r"]),
            target_modules=list(payload["target_modules"]),
            base_model_name_or_path=payload.get("base_model_name_or_path"),
        )
    except KeyError as e:
        raise ValueError(f"Failed to parse adapter_config.json: missing {e}") from e


def _load_hf_config(config_path: Path) -> tuple[ModelConfig, int, int]:
    payload = json.loads(config_path.read_text())
    required = [
        "hidden_size",
        "intermediate_size",
        "num_hidden_layers",
        "num_attention_heads",
        "num_key_value_heads",
        "vocab_size",
        "max_position_embeddings",
        "rms_norm_eps",
    ]
    missing = [k for k in required if k not in payload]
    if missing:
        raise ValueError(f"Failed to parse config.json: missing fields {missing}")

    head_dim = payload.get("head_dim") or payload["hidden_size"] // payload["num_attention_heads"]
    architectures = payload.get("architectures")
    if not architectures:
        raise ValueError("Cannot determine architecture")
    if len(architectures) != 1:
        raise ValueError(f"Multiple architectures are not supported: {architectures}")
    arch_name = architectures[0]
    if arch_name not in ARCHITECTURE_NAMES:
        raise ValueError(f"Unknown ArchitectureId: {arch_name}")

    config = ModelConfig(
        architecture_id=ARCHITECTURE_NAMES[arch_name],
        use_qk_norm=ARCHITECTURE_NAMES[arch_name] != ARCHITECTURE_LLAMA,
        dim=payload["hidden_size"],
        hidden_dim=payload["intermediate_size"],
        n_layers=payload["num_hidden_layers"],
        n_heads=payload["num_attention_heads"],
        n_kv_heads=payload["num_key_value_heads"],
        head_dim=head_dim,
        seq_len=payload["max_position_embeddings"],
        vocab_size=payload["vocab_size"],
        group_size=0,  # set by the exporter after the group-size fix
        shared_classifier=False,  # detected from the tensors by the exporter
        norm_eps=float(payload["rms_norm_eps"]),
        rope_theta=float(payload.get("rope_theta", 1e6)),
    )
    logger.info(
        "Model configuration loaded: arch=%s dim=%d layers=%d heads=%d kv_heads=%d "
        "vocab=%d seq_len=%d head_dim=%d",
        arch_name,
        config.dim,
        config.n_layers,
        config.n_heads,
        config.n_kv_heads,
        config.vocab_size,
        config.seq_len,
        config.head_dim,
    )
    return config, int(payload.get("bos_token_id") or 0), int(payload.get("eos_token_id") or 0)
