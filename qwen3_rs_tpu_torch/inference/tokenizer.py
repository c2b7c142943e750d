"""Byte-level BPE tokenizer over the binary tokenizer artifact.

The port's own copy of the reference package's tokenizer (pure Python): the
same binary format, the same greedy highest-merge-score BPE, the same
special-token scan and the same prompt-template files.

Binary format: header u32 max_token_length, u32 bos, u32 eos; then per token
id: f32 merge score, u32 byte length, raw bytes.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

TEMPLATE_SUFFIXES = {
    # (with_system, enable_thinking) -> suffix (tokenizer.rs:103-120)
    (True, True): ".template.with-system-and-thinking",
    (True, False): ".template.with-system",
    (False, True): ".template.with-thinking",
    (False, False): ".template",
}


def resolve_tokenizer_path(checkpoint_path: str | Path) -> Path:
    """Native checkpoints keep tokenizer.bin inside the directory; legacy
    checkpoints use the sibling ``<ckpt>.tokenizer`` (tokenizer.rs:43)."""
    p = Path(checkpoint_path)
    return p / "tokenizer.bin" if p.is_dir() else Path(str(p) + ".tokenizer")


def resolve_template_path(checkpoint_path: str | Path, suffix: str) -> Path:
    p = Path(checkpoint_path)
    # Native: "<dir>/template[.variant]"; legacy: "<ckpt>.template[.variant]".
    return p / suffix[1:] if p.is_dir() else Path(str(p) + suffix)


class Tokenizer:
    """Loads vocab + merge scores and encodes/decodes byte-level BPE."""

    def __init__(
        self,
        checkpoint_path: str | Path,
        vocab_size: int,
        enable_thinking: bool = False,
    ):
        tokenizer_path = resolve_tokenizer_path(checkpoint_path)
        data = tokenizer_path.read_bytes()
        self.max_token_length, self.bos_token_id, self.eos_token_id = struct.unpack_from(
            "<III", data
        )
        off = 12

        self.vocab: list[bytes] = []
        self.merge_scores: list[float] = []
        for _ in range(vocab_size):
            # Graceful degradation on short reads mirrors tokenizer.rs:56-84.
            if off + 4 > len(data):
                self.vocab.append(b"")
                self.merge_scores.append(0.0)
                continue
            (score,) = struct.unpack_from("<f", data, off)
            off += 4
            self.merge_scores.append(score)
            if off + 4 > len(data):
                self.vocab.append(b"")
                continue
            (tok_len,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + tok_len > len(data):
                self.vocab.append(b"")
                continue
            self.vocab.append(data[off : off + tok_len])
            off += tok_len
        self.vocab_size = vocab_size

        # Hash index replaces the reference's O(vocab) str_lookup scans.
        # First id wins on duplicates, matching Vec::position (first match).
        self._index: dict[bytes, int] = {}
        for i, tok in enumerate(self.vocab):
            if tok not in self._index:
                self._index[tok] = i

        self.prompt_template = self._load_template(checkpoint_path, False, enable_thinking)
        self.system_prompt_template = self._load_template(checkpoint_path, True, enable_thinking)

    @staticmethod
    def _load_template(checkpoint_path, with_system: bool, enable_thinking: bool) -> str:
        suffix = TEMPLATE_SUFFIXES[(with_system, enable_thinking)]
        path = resolve_template_path(checkpoint_path, suffix)
        try:
            return path.read_text()
        except OSError:
            logger.warning("Could not load prompt template %s", path)
            return ""

    # ------------------------------------------------------------- decoding
    def decode_bytes(self, token: int) -> bytes:
        """Raw bytes for one token (may be a partial UTF-8 sequence,
        tokenizer.rs:125-142)."""
        if 0 <= token < len(self.vocab):
            return self.vocab[token]
        return b""

    def decode(self, tokens) -> str:
        """Decode a token or a sequence to text (invalid bytes replaced)."""
        if isinstance(tokens, int):
            return self.decode_bytes(tokens).decode("utf-8", errors="replace")
        return b"".join(self.decode_bytes(t) for t in tokens).decode("utf-8", errors="replace")

    # ------------------------------------------------------------- encoding
    def _lookup(self, b: bytes) -> Optional[int]:
        return self._index.get(b)

    def encode(self, text: str) -> list[int]:
        """Encode text to token ids (tokenizer.rs:165-237).

        1. Scan for ``<...>`` special tokens (bounded by max_token_length),
           else per-character lookup (unknown characters are skipped with a
           warning, tokenizer.rs:199-201).
        2. Greedy BPE: repeatedly merge the adjacent pair whose concatenation
           is a vocab token with the highest merge score.
        """
        tokens: list[int] = []
        chars = list(text)
        i = 0
        n = len(chars)
        while i < n:
            found_special = False
            if chars[i] == "<":
                end = None
                limit = min(n, i + self.max_token_length)
                for j in range(i + 1, limit):
                    if chars[j] == ">":
                        end = j
                        break
                if end is not None:
                    special = "".join(chars[i : end + 1]).encode("utf-8")
                    tid = self._lookup(special)
                    if tid is not None:
                        tokens.append(tid)
                        i = end + 1
                        found_special = True
            if not found_special:
                tid = self._lookup(chars[i].encode("utf-8"))
                if tid is not None:
                    tokens.append(tid)
                else:
                    logger.warning("unknown character %r in input, skipping.", chars[i])
                i += 1

        # Greedy highest-score merge loop (tokenizer.rs:208-234).  Same
        # semantics as the reference (first pair with strictly-best score
        # merges each round); hash lookups instead of vocab scans.
        while True:
            best_score = -1e10
            best_id = -1
            best_idx = -1
            for k in range(len(tokens) - 1):
                merged = self.vocab[tokens[k]] + self.vocab[tokens[k + 1]]
                tid = self._index.get(merged)
                if tid is not None and self.merge_scores[tid] > best_score:
                    best_score = self.merge_scores[tid]
                    best_id = tid
                    best_idx = k
            if best_id < 0:
                break
            tokens[best_idx] = best_id
            del tokens[best_idx + 1]
        return tokens

    def is_termination(self, token: int) -> bool:
        """BOS/EOS terminate generation (generation.rs:170-172)."""
        return token in (self.bos_token_id, self.eos_token_id)

    def __repr__(self):
        return (
            f"Tokenizer(vocab_size={self.vocab_size}, "
            f"max_token_length={self.max_token_length}, "
            f"bos={self.bos_token_id}, eos={self.eos_token_id})"
        )


class Utf8StreamDecoder:
    """Incremental UTF-8 decoder for streaming token output.

    The reference prints raw token bytes as they come, relying on the
    terminal to reassemble multi-byte sequences (tokenizer.rs:125-142); here
    partial sequences are buffered until complete.
    """

    def __init__(self):
        self._buf = b""

    def push(self, data: bytes) -> str:
        buf = self._buf + data
        # Find the longest decodable prefix, keeping at most 3 trailing bytes.
        for cut in range(len(buf), max(len(buf) - 4, -1), -1):
            try:
                text = buf[:cut].decode("utf-8")
                self._buf = buf[cut:]
                return text
            except UnicodeDecodeError:
                continue
        self._buf = b""
        return buf.decode("utf-8", errors="replace")

    def flush(self) -> str:
        out = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return out
