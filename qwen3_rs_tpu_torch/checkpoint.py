"""Checkpoint reader: the native ``.qtpu`` directory and the legacy ``.bin``.

Both formats load into the same ``Qwen3Weights`` of CPU tensors; the engine
moves them to its device.  The native directory holds ``config.json`` and
``weights/*.npy`` arrays stacked per component on a leading ``[n_layers]``
axis:

    <ckpt>.qtpu/
      config.json  tokenizer.bin  template[.with-*]
      weights/
        _layout                      "in_major_v2": linear layers stored
                                     in-major (absent → v1, row-major)
        embed.q.npy [V, dim] i8      embed.s.npy [V, dim/g] f32
        wq.q.npy [L, dim, AH] i8     wq.s.npy [L, dim/g, AH] f32
        wk/wv.q.npy [L, dim, KV]     wo.q.npy [L, AH, dim]
        w1/w3.q.npy [L, dim, H]      w2.q.npy [L, H, dim]
        lm_head.q/s.npy [V, dim]     (absent when the classifier is shared)
        rms_att.npy [L, dim]  rms_ffn.npy [L, dim]  rms_final.npy [dim]
        q_norm.npy [L, hd]    k_norm.npy [L, hd]

The legacy file is the 256-byte header followed by the reference's tensor
records, row-major ``[out, in]``.  The loader builds the compute layout:

* linear layers in-major ``[L, in, out]``, with wq|wk|wv and w1|w3 fused
  along the out axis (one weight stream per fused projection);
* the classifier from the embedding (or ``lm_head``) transposed to
  ``[dim, V]`` and zero-padded on V to a multiple of ``VOCAB_PAD_MULTIPLE``
  (zero codes, unit scales); the model slices logits back to ``vocab_size``.
"""

from __future__ import annotations

import mmap
from pathlib import Path

import numpy as np
import torch

from .configuration import HEADER_SIZE, ModelConfig, read_config
from .models.qwen3 import Qwen3LayerWeights, Qwen3Weights
from .ops.quant import QuantizedTensor

WEIGHTS_DIR = "weights"
LAYOUT_MARKER = "_layout"
LAYOUT_IN_MAJOR = "in_major_v2"
VOCAB_PAD_MULTIPLE = 2048


def _t(a: np.ndarray) -> torch.Tensor:
    """An owned, contiguous CPU tensor of ``a`` (memmaps are read-only)."""
    return torch.from_numpy(np.array(a, order="C"))


def _qt(q: np.ndarray, s: np.ndarray) -> QuantizedTensor:
    return QuantizedTensor(_t(q), _t(s))


def _transposed(q: np.ndarray, s: np.ndarray) -> QuantizedTensor:
    """Row-major ``[.., out, in]`` codes / ``[.., out, in/g]`` scales →
    in-major ``[.., in, out]`` / ``[.., in/g, out]``."""
    return _qt(np.swapaxes(q, -1, -2), np.swapaxes(s, -1, -2))


def _fuse_out(*tensors: QuantizedTensor) -> QuantizedTensor:
    return QuantizedTensor(
        torch.cat([t.q for t in tensors], dim=-1), torch.cat([t.scales for t in tensors], dim=-1)
    )


def classifier_from(q_vd: np.ndarray, s_vd: np.ndarray) -> QuantizedTensor:
    """Row-major ``[V, dim]`` codes → the padded in-major classifier."""
    q_t, s_t = np.swapaxes(q_vd, -1, -2), np.swapaxes(s_vd, -1, -2)
    v = q_t.shape[-1]
    if v >= VOCAB_PAD_MULTIPLE and v % VOCAB_PAD_MULTIPLE:
        pad = VOCAB_PAD_MULTIPLE - v % VOCAB_PAD_MULTIPLE
        q_t = np.pad(q_t, [(0, 0), (0, pad)])
        s_t = np.pad(s_t, [(0, 0), (0, pad)], constant_values=1.0)
    return _qt(q_t, s_t)


def _check_bits(config: ModelConfig) -> None:
    if config.weight_bits != 8:
        raise ValueError(
            f"{config.weight_bits}-bit checkpoint: the port loads INT8 (Q8_0) checkpoints only; "
            "INT4 is not ported yet (ROADMAP.md, queue 1)"
        )


# --------------------------------------------------------------------- native
def load_native(path: str | Path) -> tuple[ModelConfig, Qwen3Weights]:
    root = Path(path)
    config = ModelConfig.from_native_json((root / "config.json").read_text())
    _check_bits(config)
    wdir = root / WEIGHTS_DIR
    marker = wdir / LAYOUT_MARKER
    in_major = marker.exists() and marker.read_text().strip() == LAYOUT_IN_MAJOR

    def arr(name):
        return np.load(wdir / f"{name}.npy", mmap_mode="r")

    def linear(name):
        q, s = arr(f"{name}.q"), arr(f"{name}.s")
        return _qt(q, s) if in_major else _transposed(q, s)

    layers = Qwen3LayerWeights(
        rms_att=_t(arr("rms_att")),
        rms_ffn=_t(arr("rms_ffn")),
        q_norm=_t(arr("q_norm")),
        k_norm=_t(arr("k_norm")),
        wqkv=_fuse_out(linear("wq"), linear("wk"), linear("wv")),
        wo=linear("wo"),
        w13=_fuse_out(linear("w1"), linear("w3")),
        w2=linear("w2"),
    )
    head = "embed" if config.shared_classifier else "lm_head"
    weights = Qwen3Weights(
        embed=_qt(arr("embed.q"), arr("embed.s")),
        layers=layers,
        rms_final=_t(arr("rms_final")),
        lm_head=classifier_from(arr(f"{head}.q"), arr(f"{head}.s")),
    )
    return config, weights


# --------------------------------------------------------------------- legacy
class _Cursor:
    """Sequential reader over a memory-mapped legacy checkpoint."""

    def __init__(self, path: str | Path):
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.offset = 0

    def take(self, count: int, dtype) -> np.ndarray:
        nbytes = count * np.dtype(dtype).itemsize
        if self.offset + nbytes > len(self._mm):
            raise ValueError(
                f"Offset {self.offset} + size {nbytes} exceeds checkpoint size {len(self._mm)}"
            )
        arr = np.frombuffer(self._mm, dtype=dtype, count=count, offset=self.offset).copy()
        self.offset += nbytes
        return arr

    def close(self):
        self._mm.close()
        self._file.close()


def _read_records(cur: _Cursor, n: int, rows: int, cols: int, g: int):
    """n consecutive (codes, scales) records → ([n, rows, cols], [n, rows, cols/g])."""
    qs, ss = [], []
    for _ in range(n):
        qs.append(cur.take(rows * cols, np.int8).reshape(rows, cols))
        ss.append(cur.take(rows * cols // g, np.float32).reshape(rows, cols // g))
    return np.stack(qs), np.stack(ss)


def load_legacy(path: str | Path) -> tuple[ModelConfig, Qwen3Weights]:
    """Load a reference-format ``.bin`` checkpoint."""
    config = read_config(path)
    _check_bits(config)
    cur = _Cursor(path)
    try:
        cur.offset = HEADER_SIZE
        l, d, hd = config.n_layers, config.dim, config.head_dim
        ah, kv, h, v = config.all_heads_dim, config.kv_dim, config.hidden_dim, config.vocab_size
        g = config.group_size
        rms_att = cur.take(l * d, np.float32).reshape(l, d)
        rms_ffn = cur.take(l * d, np.float32).reshape(l, d)
        rms_final = cur.take(d, np.float32)
        q_norm = cur.take(l * hd, np.float32).reshape(l, hd)
        k_norm = cur.take(l * hd, np.float32).reshape(l, hd)
        emb_q, emb_s = _read_records(cur, 1, v, d, g)
        wq = _read_records(cur, l, ah, d, g)
        wk = _read_records(cur, l, kv, d, g)
        wv = _read_records(cur, l, kv, d, g)
        wo = _read_records(cur, l, d, ah, g)
        w1 = _read_records(cur, l, h, d, g)
        w2 = _read_records(cur, l, d, h, g)
        w3 = _read_records(cur, l, h, d, g)
        cls_q, cls_s = (emb_q, emb_s) if config.shared_classifier else _read_records(cur, 1, v, d, g)
    finally:
        cur.close()
    layers = Qwen3LayerWeights(
        rms_att=_t(rms_att),
        rms_ffn=_t(rms_ffn),
        q_norm=_t(q_norm),
        k_norm=_t(k_norm),
        wqkv=_fuse_out(_transposed(*wq), _transposed(*wk), _transposed(*wv)),
        wo=_transposed(*wo),
        w13=_fuse_out(_transposed(*w1), _transposed(*w3)),
        w2=_transposed(*w2),
    )
    weights = Qwen3Weights(
        embed=_qt(emb_q[0], emb_s[0]),
        layers=layers,
        rms_final=_t(rms_final),
        lm_head=classifier_from(cls_q[0], cls_s[0]),
    )
    return config, weights


def load_checkpoint(path: str | Path) -> tuple[ModelConfig, Qwen3Weights]:
    """Load either format (directory → native, file → legacy) onto the CPU."""
    path = Path(path)
    if path.is_dir():
        return load_native(path)
    return load_legacy(path)
