"""qwen3_rs_tpu_torch — the PyTorch and CUDA port of the JAX package (``qwen3_rs_tpu``).

Qwen3/Llama inference from INT8-g64 or INT4 checkpoints, the HF exporter
(LoRA merged), perplexity evaluation and continuous-batching serving for one
NVIDIA H100: the same checkpoints, tokenizer, samplers, generation loops
(host sampling, or device sampling in on-device chunks), engine modes (fast
W8A16, exact W8A8; a dense decode step through the whole-step megakernel,
INT4 layers too with ``QWEN3_TPU_MEGA_Q4=1``), ``eval-ppl`` and serving
engine (dense slots or the page pool, prefix cache, chunked prefill, HTTP
front end, host or device sampling) and n-gram speculative decoding
(``inference --spec K``, serving's ``spec_k``) as the JAX package, with its Pallas
kernels replaced by hand-written CUDA kernels for Hopper (``csrc/``).
Entry points run on the card unless the caller passes ``device="cpu"``,
where the kernels' plain PyTorch versions run instead.

Tensor-parallel serving (``serve --tp N``, ``ContinuousBatchingEngine``
with a mesh), the sequence-parallel prefill (``inference --sp N``,
``inference.engine.start_sp_engine``) and the pipeline
(``parallel.pipelined_forward``) run one process per rank on
``torch.distributed`` (``parallel/``); replicated serving (``serve
--replicas R``) and the cross-host gateway (``serve --gateway``,
``serving.remote``) route requests over engines or worker servers;
``parallel.scaling_report`` measures decode on (dp, tp) meshes.  The host
helper (the tokenizer's BPE encode, the loader's transpose) is the port's own
C++ build (``utils.native``).  ``NOT_PORTED`` names what the port lacks, each
with its ``ROADMAP.md`` item: nothing.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import torch

from .checkpoint import load_checkpoint
from .configuration import ModelConfig, read_config
from .evaluation import PerplexityResult, evaluate_checkpoint
from .export import export_model
from .inference import Engine, Tokenizer, TokenSampler, chat, generate
from .inference.engine import start_sp_engine
from .serving import ContinuousBatchingEngine, Request, ServingFrontend

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
    sp_threshold: int = 4096  # min prompt rows of the sp prefill (inert while sp is 1)
    device: Optional[str] = None  # None = the card; with sp > 1 one device per rank, comma-separated

    def __post_init__(self):
        if self.seed is None:
            self.seed = int(time.time())


def run_inference(config: InferenceConfig) -> None:
    """Wire engine, tokenizer and sampler, and run generate or chat."""
    if config.speculative > 0:
        # Speculative decoding is greedy-exact only (inference/speculative.py).
        if config.temperature != 0.0:
            raise ValueError(
                "speculative decoding requires temperature 0 (greedy); "
                f"got temperature={config.temperature}"
            )
        if config.mode != "generate":
            raise ValueError("speculative decoding is generate-mode only")
        # Greedy device sampling picks the last maximum, as the host sampler
        # does: turning it on changes nothing but where the loop runs.
        config.device_sampling = True
    if config.mode not in ("generate", "chat"):
        raise ValueError(f"Unknown mode: {config.mode}")
    sampler = TokenSampler(
        config.temperature, config.topp, config.seed, device=config.device_sampling
    )
    engine_kw = dict(ctx_length=config.ctx_length, mode=config.engine_mode,
                     cache_dtype="int8" if config.kv_int8 else torch.float32)
    if config.sp > 1:
        # Sequence-parallel prefill: prompts of sp_threshold rows or more
        # shard over these devices by ring attention, one process a rank;
        # decode and short prompts stay on rank 0.
        devices = (config.device.split(",") if config.device
                   else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        if config.sp > len(devices):
            raise ValueError(f"--sp {config.sp} needs {config.sp} devices, have {len(devices)}")
        engine = start_sp_engine(functools.partial(load_checkpoint, config.checkpoint_path), devices[: config.sp],
                                 sp_threshold=config.sp_threshold, **engine_kw)
    else:
        engine = Engine(config.checkpoint_path, device=config.device, **engine_kw)
    try:
        tokenizer = Tokenizer(
            config.checkpoint_path, engine.config.vocab_size, config.enable_thinking
        )
        if config.mode == "generate":
            generate(engine, tokenizer, sampler, config.prompt, spec_k=config.speculative)
        else:
            chat(engine, tokenizer, sampler, config.prompt, config.system_prompt)
    finally:
        engine.close()


# Public names of the reference package that the port lacks (by their path
# inside the package: a module, or module.name), each with the ROADMAP.md
# item that ports it.  Every name is ported.
NOT_PORTED: dict[str, str] = {}

__all__ = [
    "ModelConfig",
    "InferenceConfig",
    "read_config",
    "load_checkpoint",
    "export_model",
    "run_inference",
    "evaluate_checkpoint",
    "PerplexityResult",
    "Engine",
    "Tokenizer",
    "TokenSampler",
    "generate",
    "chat",
    "ContinuousBatchingEngine",
    "Request",
    "ServingFrontend",
    "__version__",
]
