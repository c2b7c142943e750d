"""Chat-template export: the HF Jinja2 ``chat_template`` → ``%s`` prompt
templates.  The style (Qwen3 ``<|im_start|>`` or DeepSeek-R1 ``<｜User｜>``)
and its thinking and system support pick up to four fixed variants;
non-thinking variants carry an empty think block."""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

BASIC_SUFFIX = ".template"
WITH_THINKING_SUFFIX = ".template.with-thinking"
WITH_SYSTEM_SUFFIX = ".template.with-system"
WITH_SYSTEM_THINKING_SUFFIX = ".template.with-system-and-thinking"

_QWEN3_TEMPLATES = {  # (has_system, enable_thinking) -> template
    (False, True): "<|im_start|>user\n%s<|im_end|>\n<|im_start|>assistant\n",
    (False, False): "<|im_start|>user\n%s<|im_end|>\n<|im_start|>assistant\n<think>\n\n</think>\n\n",
    (True, True): "<|im_start|>system\n%s<|im_end|>\n<|im_start|>user\n%s<|im_end|>\n<|im_start|>assistant\n",
    (True, False): "<|im_start|>system\n%s<|im_end|>\n<|im_start|>user\n%s<|im_end|>\n<|im_start|>assistant\n<think>\n\n</think>\n\n",
}

_DEEPSEEK_TEMPLATES = {
    (False, True): "<｜User｜>%s<｜Assistant｜>",
    (False, False): "<｜User｜>%s<｜Assistant｜><think>\n</think>",
    (True, True): "%s<｜User｜>%s<｜Assistant｜>",
    (True, False): "%s<｜User｜>%s<｜Assistant｜><think>\n</think>",
}


class ChatTemplateExporter:
    def export_templates(self, model_path: str | Path, output_path: str | Path) -> None:
        """Write ``<output_path>.template[.with-*]``; raises ValueError when the
        model has no chat template or one of no known style."""
        chat_template = self._load_chat_template(Path(model_path))
        if chat_template is None:
            raise ValueError(f"No chat template found in tokenizer_config.json at {model_path}")
        template_type, supports_thinking, supports_system = self._analyze(chat_template)
        logger.info(
            "Template type: %s (thinking=%s, system=%s)", template_type, supports_thinking, supports_system
        )
        configs = [(BASIC_SUFFIX, False, False)]
        if supports_thinking:
            configs.append((WITH_THINKING_SUFFIX, True, False))
        if supports_system:
            configs.append((WITH_SYSTEM_SUFFIX, False, True))
            if supports_thinking:
                configs.append((WITH_SYSTEM_THINKING_SUFFIX, True, True))
        for suffix, enable_thinking, has_system in configs:
            content = self._render(template_type, has_system, enable_thinking)
            path = Path(str(output_path) + suffix)
            path.write_text(content)
            logger.info("Written template: %s", path)

    @staticmethod
    def _load_chat_template(model_path: Path) -> Optional[str]:
        config_path = model_path / "tokenizer_config.json"
        if not config_path.exists():
            return None
        value = json.loads(config_path.read_text()).get("chat_template")
        return value if isinstance(value, str) else None

    @staticmethod
    def _analyze(template: str) -> tuple[str, bool, bool]:
        """(style, supports thinking, supports a system prompt)."""
        if "<|im_start|>" in template and "<|im_end|>" in template:
            return (
                "qwen3",
                "enable_thinking" in template,
                "system" in template and "messages[0].role" in template,
            )
        if "<｜User｜>" in template and "<｜Assistant｜>" in template:
            return ("deepseek", "think" in template, "system_prompt" in template)
        return ("unknown", False, False)

    @staticmethod
    def _render(template_type: str, has_system: bool, enable_thinking: bool) -> str:
        if template_type == "qwen3":
            return _QWEN3_TEMPLATES[(has_system, enable_thinking)]
        if template_type == "deepseek":
            return _DEEPSEEK_TEMPLATES[(has_system, enable_thinking)]
        raise ValueError("Unknown template type, cannot render templates")
