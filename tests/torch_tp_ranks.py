"""What every rank of the port's tensor-parallel tests runs.

The tests' worker ranks are spawned processes, which import the function
they run by its module: this one, which imports the port and torch, and no
JAX.  Rank 0 is the test's own process.
"""

import torch

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
