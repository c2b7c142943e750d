"""Tokenizer export: HF ``tokenizer.json`` → the binary tokenizer.

The vocabulary is ``/model/vocab`` plus ``/added_tokens``; each token's
GPT-2 byte-level characters map back to raw bytes.  Layout: a
``(max_token_length, bos, eos)`` u32 header, then per id an ``(f32 score, u32
length, bytes)`` record.  A token's score is ``-ln(rank + 1)`` of the merge
whose *string* equals the token (merge strings are ``"left right"``, so real
tokens all get ``DEFAULT_SCORE``), as the reference exporter computes it;
both engines' encoders share that behaviour.
"""

from __future__ import annotations

import json
import logging
import math
import struct
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_SCORE = -1e6


def gpt2_unicode_to_byte_map() -> dict[str, int]:
    """Inverse GPT-2 byte-level map: printable bytes (33-126, 161-172,
    174-255) map to themselves, the rest to U+0100 upward in order."""
    mapping: dict[str, int] = {}
    covered = set()
    for lo, hi in ((33, 127), (161, 173), (174, 256)):
        for b in range(lo, hi):
            mapping[chr(b)] = b
            covered.add(b)
    n = 0
    for b in range(256):
        if b not in covered:
            mapping[chr(256 + n)] = b
            n += 1
    return mapping


def token_to_bytes(token: str, u2b: dict[str, int]) -> bytes:
    """Token string → raw bytes; a character outside the map keeps its UTF-8."""
    out = bytearray()
    for ch in token:
        b = u2b.get(ch)
        if b is not None:
            out.append(b)
        else:
            out.extend(ch.encode("utf-8"))
    return bytes(out)


class TokenizerExporter:
    TOKENIZER_FILE_NAME = "tokenizer.json"

    def export_tokenizer(self, model_path: str | Path, output_path: str | Path, bos_token_id: int,
                         eos_token_id: int) -> None:
        vocab, merge_ranks, max_token_length = self._load_token_data(Path(model_path))
        tokens_by_id = sorted(((tid, tok) for tok, tid in vocab.items()), key=lambda x: x[0])
        u2b = gpt2_unicode_to_byte_map()
        out = bytearray(struct.pack("<III", max_token_length, bos_token_id, eos_token_id))
        for _, token in tokens_by_id:
            rank = merge_ranks.get(token)
            score = -math.log(rank + 1) if rank is not None else DEFAULT_SCORE
            raw = token_to_bytes(token, u2b)
            out += struct.pack("<fI", score, len(raw))
            out += raw
        Path(output_path).write_bytes(bytes(out))
        logger.info("Written tokenizer model to %s", output_path)

    def _load_token_data(self, model_path: Path):
        tokenizer_path = model_path / self.TOKENIZER_FILE_NAME
        if not tokenizer_path.exists():
            raise FileNotFoundError(f"tokenizer.json not found in model directory: {model_path}")
        data = json.loads(tokenizer_path.read_text())
        vocab_obj = data.get("model", {}).get("vocab")
        if not isinstance(vocab_obj, dict):
            raise ValueError("Could not find vocabulary in tokenizer.json")
        vocab: dict[str, int] = {tok: int(tid) for tok, tid in vocab_obj.items() if isinstance(tid, int)}
        logger.info("Found %d tokens in model/vocab", len(vocab))
        added = data.get("added_tokens")
        if isinstance(added, list):
            for entry in added:
                content = entry.get("content") if isinstance(entry, dict) else None
                tid = entry.get("id") if isinstance(entry, dict) else None
                if isinstance(content, str) and isinstance(tid, int):
                    vocab[content] = tid
            logger.info("Added %d tokens from added_tokens", len(added))
        merge_ranks = self._extract_merge_ranks(data)
        max_token_length = max((len(t) for t in vocab), default=0)
        return vocab, merge_ranks, max_token_length

    @staticmethod
    def _extract_merge_ranks(data) -> dict[str, int]:
        """Merge string → rank; entries that are not strings are skipped."""
        merges = data.get("model", {}).get("merges")
        if not isinstance(merges, list):
            return {}
        return {m: rank for rank, m in enumerate(merges) if isinstance(m, str)}
