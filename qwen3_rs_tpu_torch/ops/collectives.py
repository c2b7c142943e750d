"""The collectives of the port's parallel layouts, counted.

The counterparts of the reference package's ``jax.lax.psum`` and
``jax.lax.ppermute`` inside its ``shard_map`` bodies (``parallel/tp.py``,
``pipeline.py``, ``context.py``): ``all_reduce`` sums a tensor over the ranks
of a process group in place, ``all_gather_last`` (``all_gather`` along any
axis) concatenates each rank's tensor in rank order, and ``exchange`` posts
one round of point-to-point sends and receives (``dist.batch_isend_irecv``,
so that no rank blocks on a send before its receive is posted).  All take
tensors on the ranks' devices: a gloo group stages a CUDA tensor of a
collective through the host itself, and ``exchange`` stages the tensors of a
gloo group's sends and receives through the host (ranks that share one card
take gloo); NCCL moves them card to card.

``COUNTS`` counts the calls; with ``TIMING["on"]`` each call is bracketed by
device synchronisations and its host seconds are added to
``TIMING["seconds"]`` (a measurement mode: the synchronisations cost time of
their own).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

COUNTS: dict[str, int] = {"all_reduce": 0, "all_gather": 0, "exchange": 0}
TIMING: dict = {"on": False, "seconds": 0.0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0
    TIMING["seconds"] = 0.0


def _timed(t: torch.Tensor, fn):
    if not TIMING["on"]:
        return fn()
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    TIMING["seconds"] += time.perf_counter() - t0
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group``, in place (contiguous)."""
    t = t.contiguous()
    COUNTS["all_reduce"] += 1
    _timed(t, lambda: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group))
    return t


def all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim``, rank 0 first."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    COUNTS["all_gather"] += 1
    _timed(t, lambda: dist.all_gather(parts, t, group=group))
    return torch.cat(parts, dim=dim)


def all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last axis, rank 0 first."""
    return all_gather(t, group, dim=-1)


def exchange(sends, recvs, group, device) -> list[torch.Tensor]:
    """One round of point-to-point messages of this rank: ``sends`` holds
    ``(tensor, peer)`` pairs, ``recvs`` ``(shape, dtype, peer)`` triples
    (peers by their rank in ``group``); returns the received tensors on
    ``device``, in the order of ``recvs``.  Every send and receive is posted
    before any is waited on."""
    stage = dist.get_backend(group) == "gloo"
    ranks = dist.get_process_group_ranks(group)  # P2POp takes global ranks
    ops, bufs = [], []
    for t, to in sends:
        t = t.contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if stage else t, ranks[to], group))
    for shape, dtype, src in recvs:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if stage else device)
        ops.append(dist.P2POp(dist.irecv, buf, ranks[src], group))
        bufs.append(buf)
    COUNTS["exchange"] += 1

    def run():
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    _timed(torch.empty(0, device=device), run)
    return [b.to(device) for b in bufs]
