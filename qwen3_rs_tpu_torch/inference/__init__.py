from .engine import Engine, TokenMetrics, TokenSampler
from .generation import chat, generate, render_prompt
from .tokenizer import Tokenizer, Utf8StreamDecoder

__all__ = [
    "Engine",
    "TokenMetrics",
    "TokenSampler",
    "Tokenizer",
    "Utf8StreamDecoder",
    "generate",
    "chat",
    "render_prompt",
]
