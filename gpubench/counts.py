"""Bytes and operations of the model's work, computed from shapes.

Frozen copies of the port's ``testing`` arithmetic (``weight_bytes_per_decode_token``,
``prefill_ops``, ``megakernel_bytes``, ``rows_cols_counts``), so that a later
change to the program cannot move the yardstick.  ``tests/test_gpubench_counts.py``
holds them equal to the port's functions at the benchmark's shapes.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The sizes the counts need (a configuration file's model, as run)."""

    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    group_size: int
    seq_len: int
    norm_eps: float = 1e-6
    rope_theta: float = 1e6
    tied: bool = True

    @property
    def all_heads_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def layer_params(self) -> int:
        return (self.dim * (self.all_heads_dim + 2 * self.kv_dim)  # wqkv
                + self.all_heads_dim * self.dim  # wo
                + 3 * self.dim * self.hidden_dim)  # w1, w3, w2


def weight_bytes_per_decode_token(c: Shapes, scale_bytes: int = 4, bits: int = 8) -> int:
    """Weights and scales streamed by one decode step: every linear layer
    once, the classifier at ``vocab_size`` columns (the embedding gather reads
    one row and is left out)."""
    scale_per_param = scale_bytes / c.group_size
    linear = c.n_layers * c.layer_params
    head = c.vocab_size * c.dim
    return int(linear * (bits / 8.0 + scale_per_param) + head * (1.0 + scale_per_param))


def prefill_ops(c: Shapes, rows: int, cache_rows: int = 0) -> dict:
    """Operations (multiply and add counted apart) of one window of ``rows``
    rows after ``cache_rows`` cached rows, b = 1: 2 per weight per row, 4·hd
    per (query head, query row, visible key), the classifier on one row."""
    visible = rows * cache_rows + rows * (rows + 1) // 2
    out = {
        "projections": 2 * rows * c.layer_params * c.n_layers,
        "attention": 4 * visible * c.head_dim * c.n_heads * c.n_layers,
        "classifier": 2 * c.dim * c.vocab_size,
    }
    out["total"] = sum(out.values())
    return out


def kv_row_bytes(head_dim: int, elem_bytes: int) -> int:
    """One K (or V) row of one kv head; INT8 rows carry an f32 scale."""
    return head_dim * elem_bytes + (4 if elem_bytes == 1 else 0)


def megakernel_bytes(c: Shapes, pos, elem_bytes: int, written: int, v_pad: int | None = None,
                     bits: int = 8) -> int:
    """Least bytes of one whole-step decode launch for rows at positions
    ``pos``: the weights and bf16 scales once (the classifier only with
    ``v_pad``), the cache rows below each position once (every layer, K and
    V), the ``written`` rows' K/V once, the f32 stream in and out and the
    logits out."""
    weights = weight_bytes_per_decode_token(c, scale_bytes=2, bits=bits)
    if v_pad is None:
        weights -= int(c.vocab_size * c.dim * (1.0 + 2 / c.group_size))
    rows = sum(min(int(p), c.seq_len) for p in pos) + written
    kv = 2 * c.n_layers * c.n_kv_heads * rows * kv_row_bytes(c.head_dim, elem_bytes)
    return weights + kv + 2 * len(pos) * c.dim * 4 + (len(pos) * v_pad * 4 if v_pad else 0)


def rows_cols_counts(rows: int, n: int, dc: int, group_size: int) -> tuple[int, float]:
    """(bytes, operations) of ``rows`` rows against ``dc`` columns of an
    INT8-g``group_size`` matrix of ``n`` rows: codes and bf16 scales, bf16
    activations in, f32 out, each once; ``2·rows·n·dc`` operations."""
    return n * dc + (n // group_size) * dc * 2 + rows * n * 2 + rows * dc * 4, 2.0 * rows * n * dc


def prefill_attention_counts(b: int, s: int, n_heads: int, n_kv_heads: int, head_dim: int) -> tuple[int, float]:
    """(bytes, operations) of one fresh causal window: bf16 q, k, v in and
    the bf16 output once; 4·hd per (head, query row, visible key)."""
    elems = b * s * head_dim * (2 * n_heads + 2 * n_kv_heads)
    return 2 * elems, 4.0 * b * n_heads * head_dim * (s * (s + 1) // 2)


def least_seconds(nbytes: float, ops: float, peak: dict) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory's rate and the operations at the bf16 tensor cores' rate."""
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["bf16_ops_per_s"])


def decode_step_least_s(c: Shapes, positions, peak: dict, elem_bytes: int = 2) -> float:
    """One decode step of the rows at ``positions`` (the rows' useful work):
    every weight once, each row's cache below it and its new K/V row, the
    logits; 2 operations per weight per row, 4·hd per (head, visible key)."""
    n = len(positions)
    nbytes = megakernel_bytes(c, positions, elem_bytes, written=n, v_pad=c.vocab_size)
    ops = (2.0 * n * (c.layer_params * c.n_layers + c.dim * c.vocab_size)
           + 4.0 * c.head_dim * c.n_heads * c.n_layers * sum(int(p) + 1 for p in positions))
    return least_seconds(nbytes, ops, peak)


def prefill_least_s(c: Shapes, rows: int, peak: dict, elem_bytes: int = 2) -> float:
    """One fresh window of ``rows`` useful rows: the weights once, the K/V
    rows written, ``prefill_ops``."""
    nbytes = (weight_bytes_per_decode_token(c, scale_bytes=2)
              + 2 * c.n_layers * c.n_kv_heads * rows * kv_row_bytes(c.head_dim, elem_bytes))
    return least_seconds(nbytes, prefill_ops(c, rows)["total"], peak)
