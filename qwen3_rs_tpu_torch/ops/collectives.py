"""The tensor-parallel forward's collectives, counted.

The counterparts of the reference package's ``jax.lax.psum`` inside its
``shard_map`` forward (``parallel/tp.py``): ``all_reduce`` sums a tensor over
the ranks of a process group in place, ``all_gather_last`` concatenates each
rank's tensor along the last axis in rank order.  Both take tensors on the
ranks' devices (a gloo group stages a CUDA tensor through the host itself).

``COUNTS`` counts the calls; with ``TIMING["on"]`` each call is bracketed by
device synchronisations and its host seconds are added to
``TIMING["seconds"]`` (a measurement mode: the synchronisations cost time of
their own).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

COUNTS: dict[str, int] = {"all_reduce": 0, "all_gather": 0}
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


def all_gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last axis, rank 0 first."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    COUNTS["all_gather"] += 1
    _timed(t, lambda: dist.all_gather(parts, t, group=group))
    return torch.cat(parts, dim=-1)
