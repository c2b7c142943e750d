"""Export: an HF model directory → a quantized checkpoint, its tokenizer and
its chat templates (numpy and JSON code; no kernels, no device)."""

from __future__ import annotations

import logging
import tempfile
from pathlib import Path

from .chat_template_exporter import ChatTemplateExporter
from .config_loader import ExportModelInfo, LoRAConfig, load_model_info
from .model_exporter import BinaryModelExporter, find_optimal_group_size
from .tokenizer_exporter import TokenizerExporter

logger = logging.getLogger(__name__)

__all__ = [
    "export_model",
    "load_model_info",
    "ExportModelInfo",
    "LoRAConfig",
    "BinaryModelExporter",
    "TokenizerExporter",
    "ChatTemplateExporter",
    "find_optimal_group_size",
]


def export_model(
    model_path: str | Path,
    output_path: str | Path,
    group_size: int = 64,
    fmt: str = "native",
    weight_bits: int = 8,
) -> list[dict]:
    """Weights, tokenizer and chat templates.

    ``fmt="native"`` writes the ``.qtpu`` directory (tokenizer and templates
    inside it); ``fmt="legacy"`` the three sibling artifacts
    ``<out>.bin``, ``<out>.tokenizer``, ``<out>.template*`` (INT8 only).
    Returns the per-tensor error report ``[{tensor, layer, max_err, bound}]``.
    """
    model_path = Path(model_path)
    output_path = Path(output_path)
    logger.info("Starting model export from %s", model_path)
    model_info = load_model_info(model_path)
    exporter = BinaryModelExporter(model_info, group_size, weight_bits)
    config = exporter.export(model_path, output_path, fmt=fmt)
    if fmt == "native":
        TokenizerExporter().export_tokenizer(
            model_path, output_path / "tokenizer.bin", model_info.bos_token_id, model_info.eos_token_id
        )
        _try_export_templates(lambda: _export_templates_native(model_path, output_path))
    else:
        TokenizerExporter().export_tokenizer(
            model_path, Path(str(output_path) + ".tokenizer"), model_info.bos_token_id, model_info.eos_token_id
        )
        _try_export_templates(lambda: ChatTemplateExporter().export_templates(model_path, output_path))
    logger.info("Export complete: %s (group_size=%d)", output_path, config.group_size)
    return exporter.error_report


def _try_export_templates(fn) -> None:
    """Templates are best-effort: a base model without a chat template (or
    with one of no known style) still exports its weights and tokenizer, and
    chat mode then runs without a template."""
    try:
        fn()
    except ValueError as e:
        logger.warning("Chat template export skipped: %s", e)


def _export_templates_native(model_path: Path, output_dir: Path) -> None:
    """The templates inside the native directory, named without the artifact
    prefix (``template``, ``template.with-system``, ...)."""
    with tempfile.TemporaryDirectory() as tmp:
        ChatTemplateExporter().export_templates(model_path, Path(tmp) / "t")
        for produced in sorted(Path(tmp).glob("t.template*")):
            (output_dir / produced.name[2:]).write_text(produced.read_text())
