"""qwen3_rs_tpu_torch — the PyTorch and CUDA port of the JAX package (``qwen3_rs_tpu``).

INT8-g64 Qwen3/Llama inference for one NVIDIA H100: the same checkpoints,
tokenizer, sampler and generation loops as the JAX package, with its Pallas
kernels replaced by hand-written CUDA kernels for Hopper (``csrc/``).  Entry
points run on the card unless the caller passes ``device="cpu"``, where the
kernels' plain PyTorch versions run instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from .checkpoint import load_checkpoint
from .configuration import ModelConfig, read_config
from .inference import Engine, Tokenizer, TokenSampler, chat, generate
from .inference.engine import not_ported

__version__ = "0.1.0"


@dataclasses.dataclass
class InferenceConfig:
    """The reference public API's fields and defaults (temperature 1.0,
    top-p 0.9, chat mode, thinking off, seed = unix time), plus ``device``."""

    checkpoint_path: str
    temperature: float = 1.0
    topp: float = 0.9
    ctx_length: Optional[int] = None
    mode: str = "chat"
    prompt: Optional[str] = None
    system_prompt: Optional[str] = None
    enable_thinking: bool = False
    seed: Optional[int] = None
    engine_mode: str = "fast"
    device_sampling: bool = False
    kv_int8: bool = False
    speculative: int = 0
    sp: int = 1
    device: Optional[str] = None  # None = the card

    def __post_init__(self):
        if self.seed is None:
            self.seed = int(time.time())


def run_inference(config: InferenceConfig) -> None:
    """Wire engine, tokenizer and sampler, and run generate or chat."""
    if config.speculative > 0:
        raise not_ported("speculative decoding (--spec)", "queue 1: speculative decoding")
    if config.sp > 1:
        raise not_ported("sequence-parallel prefill (--sp)", "queue 1: parallel layouts")
    if config.mode not in ("generate", "chat"):
        raise ValueError(f"Unknown mode: {config.mode}")
    sampler = TokenSampler(
        config.temperature, config.topp, config.seed, device=config.device_sampling
    )
    engine = Engine(
        config.checkpoint_path,
        ctx_length=config.ctx_length,
        mode=config.engine_mode,
        cache_dtype="int8" if config.kv_int8 else torch.float32,
        device=config.device,
    )
    tokenizer = Tokenizer(
        config.checkpoint_path, engine.config.vocab_size, config.enable_thinking
    )
    if config.mode == "generate":
        generate(engine, tokenizer, sampler, config.prompt)
    else:
        chat(engine, tokenizer, sampler, config.prompt, config.system_prompt)


__all__ = [
    "ModelConfig",
    "InferenceConfig",
    "read_config",
    "load_checkpoint",
    "run_inference",
    "Engine",
    "Tokenizer",
    "TokenSampler",
    "generate",
    "chat",
    "__version__",
]
