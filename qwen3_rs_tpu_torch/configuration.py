"""Model configuration and checkpoint header handling.

The port's own copy of the reference package's configuration layer, kept
bit-exact with it:

* ``ModelConfig`` is a frozen dataclass;
* the legacy single-file header is 256 bytes: 13 little-endian i32s, then an
  optional extension block (``qtp1``) carrying ``norm_eps``, ``rope_theta``
  and ``use_qk_norm`` inside the zero padding;
* the native ``.qtpu`` directory stores the same fields as ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Optional

CHECKPOINT_MAGIC = 0x616A6331  # "ajc1"
CHECKPOINT_VERSION = 1
HEADER_SIZE = 256

NATIVE_FORMAT_MAGIC = "qtpu1"

ARCHITECTURE_QWEN3 = 1
ARCHITECTURE_LLAMA = 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of a checkpoint."""

    architecture_id: int
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    seq_len: int
    vocab_size: int
    group_size: int
    shared_classifier: bool
    norm_eps: float = 1e-6
    rope_theta: float = 1e6
    # Qwen3 applies per-head RMSNorm to Q/K before RoPE; Llama does not.
    use_qk_norm: bool = True
    # Linear-layer code width: 8 = Q8_0, 4 = nibble-packed INT4 (native
    # format only).  The port loads 8-bit checkpoints only.
    weight_bits: int = 8

    @property
    def all_heads_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def kv_mul(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ModelConfig":
        positive = dict(
            architecture_id=self.architecture_id,
            dim=self.dim,
            n_layers=self.n_layers,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            vocab_size=self.vocab_size,
            seq_len=self.seq_len,
            head_dim=self.head_dim,
        )
        for name, value in positive.items():
            if value <= 0:
                raise ValueError(f"Invalid {name}: must be positive, got {value}")
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be divisible by n_kv_heads ({self.n_kv_heads})"
            )
        if self.weight_bits not in (8, 4):
            raise ValueError(f"weight_bits must be 8 or 4, got {self.weight_bits}")
        if self.weight_bits == 4 and self.group_size % 2:
            raise ValueError("INT4 packing needs an even group_size")
        return self

    def with_seq_len(self, ctx_length: Optional[int]) -> "ModelConfig":
        """Clamp seq_len by a user context override."""
        if ctx_length is None or ctx_length <= 0 or ctx_length >= self.seq_len:
            return self
        return dataclasses.replace(self, seq_len=ctx_length)

    # ---------------------------------------------------------------- legacy
    _EXT_MAGIC = 0x71747031  # "qtp1"

    def to_legacy_header(self) -> bytes:
        if self.weight_bits != 8:
            raise ValueError(
                "the legacy .bin format is Q8_0-only; export INT4 checkpoints "
                "in the native format"
            )
        packed = struct.pack(
            "<13i",
            CHECKPOINT_MAGIC,
            CHECKPOINT_VERSION,
            self.architecture_id,
            self.dim,
            self.hidden_dim,
            self.n_layers,
            self.n_heads,
            self.n_kv_heads,
            self.vocab_size,
            self.seq_len,
            self.head_dim,
            1 if self.shared_classifier else 0,
            self.group_size,
        )
        packed += struct.pack(
            "<IddI", self._EXT_MAGIC, self.norm_eps, self.rope_theta, int(self.use_qk_norm)
        )
        return packed + b"\x00" * (HEADER_SIZE - len(packed))

    @classmethod
    def from_legacy_header(cls, data: bytes) -> "ModelConfig":
        if len(data) < 13 * 4:
            raise ValueError(
                f"Insufficient data for config: need {13 * 4} bytes, got {len(data)}"
            )
        (
            magic,
            version,
            architecture_id,
            dim,
            hidden_dim,
            n_layers,
            n_heads,
            n_kv_heads,
            vocab_size,
            seq_len,
            head_dim,
            shared_classifier,
            group_size,
        ) = struct.unpack_from("<13i", data)
        if magic != CHECKPOINT_MAGIC:
            raise ValueError(
                f"Invalid checkpoint magic number: expected {CHECKPOINT_MAGIC:#x}, got {magic:#x}"
            )
        if version != CHECKPOINT_VERSION:
            raise ValueError(
                f"Unsupported checkpoint version: expected {CHECKPOINT_VERSION}, got {version}"
            )
        extras = {}
        if len(data) >= 13 * 4 + 24:
            ext_magic, eps, theta, qk = struct.unpack_from("<IddI", data, 13 * 4)
            if ext_magic == cls._EXT_MAGIC:
                extras = dict(norm_eps=eps, rope_theta=theta, use_qk_norm=bool(qk))
        if not extras and architecture_id == ARCHITECTURE_LLAMA:
            extras = dict(use_qk_norm=False)
        return cls(
            architecture_id=architecture_id,
            dim=dim,
            hidden_dim=hidden_dim,
            n_layers=n_layers,
            n_heads=n_heads,
            n_kv_heads=n_kv_heads,
            head_dim=head_dim,
            seq_len=seq_len,
            vocab_size=vocab_size,
            group_size=group_size,
            shared_classifier=shared_classifier != 0,
            **extras,
        ).validate()

    # ---------------------------------------------------------------- native
    def to_native_json(self) -> str:
        payload = {"magic": NATIVE_FORMAT_MAGIC, "version": CHECKPOINT_VERSION}
        if self.weight_bits == 4:
            payload["q4_pack"] = "biased-v2"
        payload.update(dataclasses.asdict(self))
        return json.dumps(payload, indent=2)

    @classmethod
    def from_native_json(cls, text: str) -> "ModelConfig":
        payload = json.loads(text)
        if payload.get("magic") != NATIVE_FORMAT_MAGIC:
            raise ValueError(
                f"Invalid native checkpoint magic: expected {NATIVE_FORMAT_MAGIC!r}, "
                f"got {payload.get('magic')!r}"
            )
        if payload.get("version") != CHECKPOINT_VERSION:
            raise ValueError(f"Unsupported native checkpoint version: {payload.get('version')}")
        if payload.get("weight_bits") == 4 and payload.get("q4_pack") != "biased-v2":
            raise ValueError(
                "This INT4 checkpoint uses the pre-biased-v2 nibble packing; re-export it"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in fields}).validate()


def read_config(path: str | Path) -> ModelConfig:
    """Directory with config.json → native format; file → legacy header."""
    path = Path(path)
    if path.is_dir():
        return ModelConfig.from_native_json((path / "config.json").read_text())
    with open(path, "rb") as f:
        return ModelConfig.from_legacy_header(f.read(HEADER_SIZE))
