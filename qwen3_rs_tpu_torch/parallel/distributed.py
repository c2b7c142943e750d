"""Process groups: joining one, starting the ranks of one on this host, and
the scaling harness.

The port of the reference package's ``parallel/distributed.py``.  There
``initialize_distributed`` wraps ``jax.distributed.initialize``; here it
wraps ``torch.distributed.init_process_group`` over a TCP rendezvous, given
its address, world size and rank (nothing tells a process of a cluster).

``launch`` starts the ranks of a group on this host (a (dp, tp) one, or with
``axis`` a pipeline or sequence-parallel one): ranks 1..N-1 as processes of
their own (the ``spawn`` start method, a free local port), each running
``target(mesh, *args)``, and this process as rank 0.
The kernels are built once, by rank 0, before the workers start, so that no
two processes compile them at once (the build also installs each library by
an atomic rename).  A worker that dies is seen by rank 0 (``Workers.check``);
a worker whose rank 0 is gone exits.

The collectives' timeout is ``GROUP_TIMEOUT``; the serving front end sends a
heartbeat while it is idle, so that an idle server never waits that long.

``scaling_report`` measures greedy decode throughput at increasing device
counts on a (n // tp, tp) mesh and the scaling efficiency against one
device, as the reference's does; ``decode_run`` is one of its measurements
with each rank's greedy tokens.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import socket
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..configuration import ModelConfig
from .mesh import TP_AXIS, Mesh, backend_for, create_mesh

logger = logging.getLogger(__name__)

GROUP_TIMEOUT = datetime.timedelta(hours=1)  # any one collective, the rendezvous included
START_TIMEOUT_S = 300.0  # for the workers to reach the rendezvous


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "gloo",
) -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, at ``coordinator_address`` ("host:port", which rank 0
    serves).  With no arguments, ``torch.distributed``'s environment
    variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    say it."""
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, timeout=GROUP_TIMEOUT, **kw)
    logger.info("process group up: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(), backend)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Workers:
    """Ranks 1..N-1 of a group, as processes of this host."""

    def __init__(self, procs: list):
        self.procs = procs

    def check(self) -> None:
        """Raise if a worker has exited."""
        for rank, p in enumerate(self.procs, 1):
            if not p.is_alive():
                raise RuntimeError(f"rank {rank} of the group exited with code {p.exitcode}")

    def join(self, timeout: float = 60.0) -> None:
        """Wait for the workers to exit; stop those that do not."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def _watch_parent(parent: int) -> None:
    """Exit this worker when the process that started it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _mesh(axis: str, devices, dp: int = 1) -> Mesh:
    """This rank's mesh over every rank of the group: (dp, n // dp) on the tp
    axis, or all on ``axis``."""
    if axis == TP_AXIS:
        return create_mesh(tp=len(devices) // dp, dp=dp, devices=devices)
    if dp != 1:
        raise ValueError(f"a {axis} mesh has no dp axis")
    return create_mesh(devices=devices, **{axis: len(devices)})


def _rank_main(rank: int, addr: str, devices: list[str], parent: int, target, args, axis: str = TP_AXIS,
               dp: int = 1, build_dir: Optional[str] = None) -> None:
    torch.set_num_threads(1)
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    if build_dir is not None:  # rank 0's build directory (``utils.enable_compile_cache``)
        from ..ops.kernels import build

        build.BUILD_DIR = Path(build_dir)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = addr.split(":")
    store = dist.TCPStore(host, int(port), len(devices), is_master=False, timeout=GROUP_TIMEOUT)
    store.set(f"rank{rank}", "up")
    dist.init_process_group(backend_for(devices), store=store, rank=rank, world_size=len(devices),
                            timeout=GROUP_TIMEOUT)
    mesh = _mesh(axis, devices, dp)
    try:
        target(mesh, *args)
    finally:
        dist.destroy_process_group()


def launch(devices: Sequence, target, *args, axis: str = TP_AXIS, dp: int = 1) -> Mesh:
    """Start a group over ``devices`` (one rank each, in order) whose mesh
    spans them on ``axis`` (``"tp"``, ``"pp"`` or ``"sp"``; on ``"tp"``, a
    (dp, n // dp) mesh): ranks 1..N-1 run ``target(mesh, *args)`` in
    processes of their own (``target`` and ``args`` must pickle, and import
    no JAX); this process joins as rank 0.  Returns rank 0's mesh, whose
    ``workers`` hold the processes and whose ``close()`` joins them."""
    from ..ops.kernels import build

    devices = [str(torch.device(d)) for d in devices]
    n = len(devices)
    if n < 2:
        raise ValueError("launch needs two devices or more; a one-device mesh needs no process group")
    if dp < 1 or n % dp:
        raise ValueError(f"dp ({dp}) must divide the device count ({n})")
    if any(torch.device(d).type == "cuda" for d in devices):
        build.build()  # once, here, before any worker could start a build of its own
    host, port = "127.0.0.1", free_port()
    store = dist.TCPStore(host, port, n, is_master=True, timeout=GROUP_TIMEOUT, wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, f"{host}:{port}", devices, os.getpid(), target, args, axis, dp,
                                                  str(build.BUILD_DIR)),
                         daemon=True, name=f"{axis}-rank{r}") for r in range(1, n)]
    for p in procs:
        p.start()
    workers = Workers(procs)
    deadline = time.monotonic() + START_TIMEOUT_S
    try:
        while not store.check([f"rank{r}" for r in range(1, n)]):
            workers.check()
            if time.monotonic() > deadline:
                raise RuntimeError(f"the group's workers did not start within {START_TIMEOUT_S:.0f} s")
            time.sleep(0.05)
        dev = torch.device(devices[0])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(devices), store=store, rank=0, world_size=n, timeout=GROUP_TIMEOUT)
    except BaseException:
        workers.join(timeout=0)
        raise
    mesh = _mesh(axis, devices, dp)
    mesh.workers = workers
    return mesh


# ------------------------------------------------------------ scaling harness
def _decode_rank(mesh: Mesh, config: ModelConfig, weights, batch_per_dp: int, steps: int,
                 first_tokens: Optional[np.ndarray]):
    """One rank of ``decode_run``: this rank's shard of the weights, a bf16
    dense cache of its replica's rows and its kv heads, greedy fast-mode
    decode of ``steps`` and ``max(steps // 4, 1)`` steps from the first
    tokens at position 0, each length warmed once and then timed twice on a
    fresh cache (the best kept), every rank starting together.  Returns, on
    rank 0 (None elsewhere), every rank's ``(t_long, t_short, tokens
    [batch_per_dp, steps], first step's logits [batch_per_dp, vocab])``."""
    from ..models.qwen3 import cast_weight_scales, init_kv_cache, qwen3_forward, weights_to
    from .tp import local_config, shard_weights_tp

    dev, tp = mesh.device, mesh.tp
    w = weights() if callable(weights) else weights
    if tp > 1:
        w = shard_weights_tp(w, mesh, config)
    w = cast_weight_scales(weights_to(w, dev))
    cfg = local_config(config, tp)
    rows = slice(mesh.dp_index * batch_per_dp, (mesh.dp_index + 1) * batch_per_dp)
    first = (torch.ones(batch_per_dp, 1, dtype=torch.long) if first_tokens is None
             else torch.as_tensor(np.asarray(first_tokens)[rows], dtype=torch.long).reshape(batch_per_dp, 1))
    first = first.to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if mesh.group is not None:
            dist.barrier(group=mesh.group)

    def run(n_steps: int, keep_logits: bool = False):
        cache = init_kv_cache(cfg, batch_per_dp, dtype=torch.bfloat16, device=dev)
        tok, toks, logits0 = first, [], None
        sync()
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, cache = qwen3_forward(cfg, w, tok, cache, np.full(batch_per_dp, i), mode="fast",
                                          tp_group=mesh.tp_group)
            if keep_logits and i == 0:
                logits0 = logits.clone()
            tok = logits.argmax(-1, keepdim=True)  # the first maximum, as jnp.argmax; on the device
            toks.append(tok)
        out = torch.cat(toks, 1).cpu()  # the one read to the host
        return time.perf_counter() - t0, out, logits0

    def best(n_steps: int):
        _, toks, logits0 = run(n_steps, keep_logits=True)  # warm
        return min(run(n_steps)[0] for _ in range(2)), toks, logits0

    t_long, toks, logits0 = best(steps)
    t_short = best(max(steps // 4, 1))[0]
    mine = (t_long, t_short, toks.numpy(), logits0.float().cpu().numpy())
    if mesh.group is None:
        return [mine]
    got = [None] * len(mesh.devices) if mesh.rank == 0 else None
    dist.gather_object(mine, got, dst=0)
    return got


def decode_run(config: ModelConfig, weights, devices: Sequence, *, tp: int, batch_per_dp: int, steps: int = 32,
               first_tokens=None) -> dict:
    """Greedy decode over a (len(devices) // tp, tp) mesh: ``throughput``
    (tokens/s of the whole batch, ``batch_per_dp · dp`` rows, from the slope
    between the long and the short run of the slowest rank; the long run's
    seconds a step where that slope is not positive, as the reference does),
    and each rank's ``tokens`` ([batch_per_dp, steps] ints of its replica's
    rows) and ``logits`` of the first step, in rank order.

    ``weights``: the whole ``Qwen3Weights``, or a callable that returns them
    on each rank (so that large weights are not pickled to every rank).
    ``first_tokens``: ``[batch]`` ints fed at position 0 (default: token 1,
    as the reference feeds).  One device runs in this process; more start a
    group of their own (``launch``), which this process must not be in."""
    devices = [str(torch.device(d)) for d in devices]
    n = len(devices)
    if n % tp:
        raise ValueError(f"tp ({tp}) must divide the device count ({n})")
    args = (config, weights, batch_per_dp, steps, first_tokens)
    if n == 1:
        got = _decode_rank(create_mesh(tp=1, dp=1, devices=devices), *args)
    else:
        if dist.is_initialized():
            raise RuntimeError("a process group is up in this process: decode_run starts a group of its own")
        mesh = launch(devices, _decode_rank, *args, dp=n // tp)
        try:
            got = _decode_rank(mesh, *args)
        finally:
            mesh.close()
    steps_short = max(steps // 4, 1)
    t_long, t_short = max(g[0] for g in got), max(g[1] for g in got)
    per_step = (t_long - t_short) / (steps - steps_short) if steps > steps_short else 0.0
    if per_step <= 0:
        # Degenerate slope (ranks contending for one host or card): the long
        # run's seconds a step, dispatch included, but positive.
        per_step = t_long / steps
    return {"throughput": batch_per_dp * (n // tp) / per_step, "seconds": {"long": t_long, "short": t_short},
            "tokens": [g[2] for g in got], "logits": [g[3] for g in got]}


def _throughput_on(config: ModelConfig, weights, devices: Sequence, *, tp: int, batch_per_dp: int,
                   steps: int = 32) -> float:
    """Decode tokens/sec over a (dp, tp) mesh on the given devices."""
    return decode_run(config, weights, devices, tp=tp, batch_per_dp=batch_per_dp, steps=steps)["throughput"]


def scaling_report(config: ModelConfig, weights, *, device_counts: Optional[Sequence[int]] = None,
                   tp_per_group: int = 1, batch_per_dp: int = 1, steps: int = 32,
                   devices: Optional[Sequence] = None) -> dict:
    """Throughput at increasing device counts + efficiency vs 1 device.

    Efficiency(n) = throughput(n) / (n × throughput(1)), the first count
    standing in for 1.  ``devices`` (default: every visible card) lists the
    devices of the largest count; the first n make the count-n mesh.  Ranks
    may share a device (``["cuda:0"] * 4``: gloo, the one-card counterpart of
    the reference's virtual CPU mesh), and then the numbers are the cost of
    the path on that device, not the layout's value."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("CUDA is not available: pass devices (e.g. ['cpu'] * n) to run on the CPU")
    devices = list(devices)
    if device_counts is None:
        device_counts = sorted({c for c in (1, 2, 4, 8, len(devices)) if c <= len(devices)})
    results = {}
    for n in device_counts:
        tput = _throughput_on(config, weights, devices[:n], tp=min(tp_per_group, n), batch_per_dp=batch_per_dp,
                              steps=steps)
        results[n] = tput
        logger.info("devices=%d → %.1f tok/s", n, tput)
    base = results[device_counts[0]] / device_counts[0]
    return {"throughput": results, "efficiency": {n: results[n] / (n * base) for n in device_counts}}
