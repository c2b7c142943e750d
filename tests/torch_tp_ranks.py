"""What every rank of the port's multi-rank tests runs (tensor, pipeline
and sequence parallelism).

The tests' worker ranks are spawned processes, which import the function
they run by its module: this one, which imports the port and torch, and no
JAX.  Rank 0 is the test's own process.  ``Ranks`` keeps one group for many
calls: its workers run ``follow`` and take each call rank 0 broadcasts.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from qwen3_rs_tpu_torch.parallel import launch

from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache
from qwen3_rs_tpu_torch.parallel.tp import local_config, make_tp_forward, shard_weights_tp
from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache


def model(config, weights):
    """A weight source for ``start_tp_engine``: the given weights."""
    return config, weights


def run_calls(mesh, config, weights, sequences):
    """Each sequence through this rank's tp forward: ``{"mode", "weights"
    (a key of ``weights``), "cache": ("dense", batch) or ("paged", pages,
    page), "calls": [(tokens, pos, kwargs), ...]}``, the calls in order on one
    fresh cache.  Returns the logits of every call.  A worker rank runs it
    as its target, on the same arguments as rank 0."""
    local = local_config(config, mesh.tp)
    shards = {k: shard_weights_tp(w, mesh, config) for k, w in weights.items()}
    out = []
    for seq in sequences:
        w = shards[seq["weights"]]
        if seq["mode"] == "fast":
            w = cast_weight_scales(w)
        kind, *size = seq["cache"]
        cache = (init_kv_cache(local, size[0], dtype=torch.bfloat16, device="cpu") if kind == "dense"
                 else init_paged_cache(local, size[0], size[1], device="cpu"))
        fwd = make_tp_forward(config, mesh, mode=seq["mode"])
        logits = []
        for tokens, pos, kw in seq["calls"]:
            lg, cache = fwd(w, tokens, cache, pos, **kw)
            logits.append(lg)
        out.append(logits)
    return out


def mesh_report(mesh):
    """This rank's place in a (dp, tp) mesh: its coordinates, the ranks of
    its tp and dp subgroups, each subgroup's sum of its ranks' indices (an
    all-reduce over it) and its kernels' build directory; gathered to rank 0,
    in rank order."""
    def over(group):
        if group is None:
            return None, mesh.rank
        t = torch.tensor([float(mesh.rank)])
        dist.all_reduce(t, group=group)
        return dist.get_process_group_ranks(group), int(t.item())

    from qwen3_rs_tpu_torch.ops.kernels import build

    mine = {"rank": mesh.rank, "dp": mesh.dp_index, "tp": mesh.tp_index, "tp_group": over(mesh.tp_group),
            "dp_group": over(mesh.dp_group), "parts": mesh.parts(), "build_dir": str(build.BUILD_DIR)}
    got = [None] * len(mesh.devices) if mesh.rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    return got


def follow(mesh):
    """A worker rank of ``Ranks``: run each ``(fn, args)`` rank 0 broadcasts,
    ``fn(mesh, *args)``, until it sends None."""
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        if box[0] is None:
            return
        fn, args = box[0]
        fn(mesh, *args)


class Ranks:
    """Rank 0's handle of a group of ``devices`` whose mesh spans them on
    ``axis``: ``run(fn, *args)`` runs ``fn(mesh, *args)`` on every rank (a
    function of this module, and arguments that pickle) and returns rank 0's
    result; ``close()`` stops the workers and leaves the group."""

    def __init__(self, devices, axis):
        self.mesh = launch(devices, follow, axis=axis)

    def run(self, fn, *args):
        dist.broadcast_object_list([(fn, args)], src=0)
        return fn(self.mesh, *args)

    def close(self):
        try:
            dist.broadcast_object_list([None], src=0)
        finally:
            self.mesh.close()


def on_axis(mesh, axis):
    """The same group's mesh named on ``axis``."""
    return dataclasses.replace(mesh, shape={axis: len(mesh.devices)}, workers=None)


def pipeline_calls(mesh, config, weights, calls, m, mode):
    """``calls`` ([(tokens, pos)], in order on one fresh f32 dense cache)
    through ``pipelined_forward`` on this rank; returns each call's logits and
    this rank's cache slab after the last."""
    from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache
    from qwen3_rs_tpu_torch.parallel import pipelined_forward

    cache = init_kv_cache(config, len(calls[0][0]), device="cpu")
    out = []
    for tokens, pos in calls:
        logits, slab = pipelined_forward(config, weights, tokens, cache, pos, mesh, n_microbatches=m, mode=mode)
        out.append(logits)
    return out, slab


def pp_shards(mesh, weights, cache):
    """This rank's ``shard_for_pp`` slabs."""
    from qwen3_rs_tpu_torch.parallel import shard_for_pp

    return shard_for_pp(weights, cache, mesh)


def ring(mesh, q, k, v):
    """``ring_prefill_attention`` on this rank, and the inner form on its rows."""
    from qwen3_rs_tpu_torch.parallel import ring_prefill_attention, ring_prefill_attention_inner

    mesh = on_axis(mesh, "sp")
    n = len(mesh.devices)
    q, k, v = (t.to(mesh.device) for t in (q, k, v))
    rows = slice(mesh.rank * q.shape[1] // n, (mesh.rank + 1) * q.shape[1] // n)
    inner = ring_prefill_attention_inner(q[:, rows].contiguous(), k[:, rows].contiguous(), v[:, rows].contiguous(),
                                         mesh)
    return ring_prefill_attention(q, k, v, mesh).cpu(), inner.cpu()


def sp_forward(mesh, config, weights, tokens, kw):
    """``qwen3_forward(sp_mesh=...)`` of a fresh window on this rank (rank 0
    over a fresh f32 dense cache)."""
    from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward

    mesh = on_axis(mesh, "sp")
    cache = init_kv_cache(config, len(tokens), device="cpu") if mesh.rank == 0 else None
    return qwen3_forward(config, weights, tokens, cache, np.zeros(len(tokens), np.int64), fresh_prefill=True,
                         sp_mesh=mesh, **kw)


def pipeline_on_card(mesh, config, seed, calls, m):
    """``calls`` through ``pipelined_forward`` (fast mode) on this rank's card,
    over the weights of ``seed`` drawn there (``testing.random_weights``, bf16 scales) and
    a fresh bf16 dense cache; returns rank 0's logits of each call (on the
    host) and every rank's kernel launches during the calls, rank 0 first."""
    from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from qwen3_rs_tpu_torch.parallel import pipelined_forward
    from qwen3_rs_tpu_torch.testing import random_weights

    weights = cast_weight_scales(random_weights(config, seed, device=mesh.device))  # bf16 scales, as fast mode keeps
    cache = init_kv_cache(config, len(calls[0][0]), dtype=torch.bfloat16, device=mesh.device)
    reset_launches()
    out = []
    for tokens, pos in calls:
        logits, cache = pipelined_forward(config, weights, tokens, cache, pos, mesh, n_microbatches=m)
        out.append(logits.cpu())
    if len(mesh.devices) == 1:
        return out, [dict(LAUNCHES)]
    counts = [None] * len(mesh.devices) if mesh.rank == 0 else None
    dist.gather_object(dict(LAUNCHES), counts, dst=0)
    return out, counts
