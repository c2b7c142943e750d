"""Context (sequence) parallelism: ring attention for a sharded prefill.

The port of the reference package's ``parallel/context.py``.  The prompt's
rows are sharded over the ranks of an ``sp`` mesh: rank r holds the S/N
query rows from r·S/N.  Queries stay where they are and the K/V blocks go
round the ring: at step t rank r holds the block first owned by rank
(r + t) mod N, attends its queries to it and merges the partial into its
running online-softmax state ``(m, l, acc)`` in f32
(``ops.attention.merge_softmax_partials``), then sends the block to rank
r - 1 and takes the next from rank r + 1 (``ops.collectives.exchange``:
N - 1 exchanges in all).  The score tensor is ``(S/N)²`` a rank, never
``S²``.

The block attention is plain PyTorch, as the reference computes it with XLA
einsums (no Pallas kernel).  A block that lies wholly above a rank's rows
(every key later than every query) is all masked: its partial is zero, so it
is not computed; the exchanges keep the reference's schedule.

``ring_prefill_attention_inner`` takes and returns this rank's rows (the form
``models.qwen3.qwen3_forward(sp_mesh=...)`` calls on every rank);
``ring_prefill_attention`` takes the whole sequence, the same on every rank,
and returns the whole output on every rank.
"""

from __future__ import annotations

import torch

from ..ops.attention import merge_softmax_partials
from ..ops.collectives import all_gather, exchange
from .mesh import SP_AXIS, Mesh


def _local_block_attention(q, k, v, q_start: int, k_start: int, scale: float):
    """Causal GQA attention of local queries against one K/V block: q
    ``[B, Sq, KV, M, hd]`` f32 (global rows from ``q_start``), k/v
    ``[B, Sk, KV, hd]`` (global rows from ``k_start``) → the (m, l, acc)
    partials ``[B, KV, M, Sq, 1 | 1 | hd]``."""
    sq, sk = q.shape[1], k.shape[1]
    dev = q.device
    scores = torch.einsum("bsnmh,bjnh->bnmsj", q, k.float()) * scale
    rows = q_start + torch.arange(sq, device=dev)[:, None]
    cols = k_start + torch.arange(sk, device=dev)[None, :]
    scores = scores.masked_fill(~(rows >= cols), float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)  # -inf where a row sees no key of the block
    e = torch.where(torch.isfinite(m), torch.exp(scores - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bnmsj,bjnh->bnmsh", e, v.float())
    return m, l, acc


def _check(s_total: int, n_shards: int, axis: str) -> None:
    if s_total % n_shards:
        raise ValueError(f"sequence length {s_total} must divide over {axis}={n_shards}")


def _ring(q, k, v, mesh: Mesh, axis: str) -> torch.Tensor:
    b, s_loc, n_heads, hd = q.shape
    n_kv = k.shape[2]
    kv_mul = n_heads // n_kv
    n, idx = mesh.shape[axis], mesh.rank
    dev = q.device
    qf = q.reshape(b, s_loc, n_kv, kv_mul, hd).float()
    q_start = idx * s_loc
    scale = 1.0 / (hd**0.5)
    m = torch.full((b, n_kv, kv_mul, s_loc, 1), float("-inf"), device=dev)
    l = torch.zeros((b, n_kv, kv_mul, s_loc, 1), device=dev)
    acc = torch.zeros((b, n_kv, kv_mul, s_loc, hd), device=dev)
    for t in range(n):
        src = (idx + t) % n
        if src * s_loc <= q_start + s_loc - 1:  # some key of the block at or before a query row
            m, l, acc = merge_softmax_partials(m, l, acc, *_local_block_attention(qf, k, v, q_start, src * s_loc, scale))
        if t + 1 < n:
            k, v = exchange([(k, (idx - 1) % n), (v, (idx - 1) % n)],
                            [(k.shape, k.dtype, (idx + 1) % n), (v.shape, v.dtype, (idx + 1) % n)], mesh.group, dev)
    out = acc / torch.where(l == 0.0, 1.0, l)  # row 0 of shard 0 always sees its own key
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_loc, n_heads, hd).to(q.dtype)


def ring_prefill_attention_inner(
    q: torch.Tensor,  # [B, S/N, n_heads, hd]: this rank's rows
    k: torch.Tensor,  # [B, S/N, n_kv, hd]
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = SP_AXIS,
) -> torch.Tensor:
    """Causal GQA prefill attention of this rank's rows (global rows from
    ``rank · S/N``) over the whole sequence, every rank calling it with its
    own rows; returns this rank's rows of the output ``[B, S/N, n_heads,
    hd]`` in ``q.dtype``."""
    n = mesh.shape[axis]
    _check(q.shape[1] * n, n, axis)
    return _ring(q, k, v, mesh, axis)


def ring_prefill_attention(
    q: torch.Tensor,  # [B, S, n_heads, hd], the same on every rank
    k: torch.Tensor,  # [B, S, n_kv, hd]
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis: str = SP_AXIS,
) -> torch.Tensor:
    """Causal GQA prefill attention with the sequence sharded over ``axis``.

    Equal to ``ops.attention.gqa_attention`` over the whole sequence (rows
    at absolute positions 0..S-1) up to the order of the f32 sums, computed
    with each rank holding only S/N of the rows and one K/V block at a time.
    ``S`` must divide evenly over the axis.  Every rank of the mesh calls it
    with the same tensors and gets the whole output."""
    n = mesh.shape[axis]
    _check(q.shape[1], n, axis)
    s_loc = q.shape[1] // n
    rows = slice(mesh.rank * s_loc, (mesh.rank + 1) * s_loc)
    out = _ring(q[:, rows].contiguous(), k[:, rows].contiguous(), v[:, rows].contiguous(), mesh, axis)
    return out if n == 1 else all_gather(out, mesh.group, dim=1)
