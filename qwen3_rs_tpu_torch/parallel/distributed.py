"""Process groups: joining one, and starting the ranks of one on this host.

The port of the reference package's ``parallel/distributed.py``.  There
``initialize_distributed`` wraps ``jax.distributed.initialize``; here it
wraps ``torch.distributed.init_process_group`` over a TCP rendezvous, given
its address, world size and rank (nothing tells a process of a cluster).

``launch`` starts the ranks of a group on this host (a tensor-parallel one,
or with ``axis`` a pipeline or sequence-parallel one): ranks 1..N-1 as
processes of their own (the ``spawn`` start method, a free local port), each
running ``target(mesh, *args)``, and this process as rank 0.
The kernels are built once, by rank 0, before the workers start, so that no
two processes compile them at once (the build also installs each library by
an atomic rename).  A worker that dies is seen by rank 0 (``Workers.check``);
a worker whose rank 0 is gone exits.

The collectives' timeout is ``GROUP_TIMEOUT``; the serving front end sends a
heartbeat while it is idle, so that an idle server never waits that long.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
import os
import socket
import threading
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

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


def _mesh(axis: str, devices) -> Mesh:
    """This rank's mesh over every rank of the group, on ``axis``."""
    return create_mesh(devices=devices, **{axis: len(devices)})


def _rank_main(rank: int, addr: str, devices: list[str], parent: int, target, args, axis: str = TP_AXIS) -> None:
    torch.set_num_threads(1)
    threading.Thread(target=_watch_parent, args=(parent,), daemon=True).start()
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = addr.split(":")
    store = dist.TCPStore(host, int(port), len(devices), is_master=False, timeout=GROUP_TIMEOUT)
    store.set(f"rank{rank}", "up")
    dist.init_process_group(backend_for(devices), store=store, rank=rank, world_size=len(devices),
                            timeout=GROUP_TIMEOUT)
    mesh = _mesh(axis, devices)
    try:
        target(mesh, *args)
    finally:
        dist.destroy_process_group()


def launch(devices: Sequence, target, *args, axis: str = TP_AXIS) -> Mesh:
    """Start a group over ``devices`` (one rank each, in order) whose mesh
    spans them on ``axis`` (``"tp"``, ``"pp"`` or ``"sp"``): ranks 1..N-1
    run ``target(mesh, *args)`` in processes of their own (``target`` and
    ``args`` must pickle, and import no JAX); this process joins as rank 0.
    Returns rank 0's mesh, whose ``workers`` hold the processes and whose
    ``close()`` joins them."""
    devices = [str(torch.device(d)) for d in devices]
    n = len(devices)
    if n < 2:
        raise ValueError("launch needs two devices or more; a one-device mesh needs no process group")
    if any(torch.device(d).type == "cuda" for d in devices):
        from ..ops.kernels import build

        build.build()  # once, here, before any worker could start a build of its own
    host, port = "127.0.0.1", free_port()
    store = dist.TCPStore(host, port, n, is_master=True, timeout=GROUP_TIMEOUT, wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, f"{host}:{port}", devices, os.getpid(), target, args, axis),
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
    mesh = _mesh(axis, devices)
    mesh.workers = workers
    return mesh
