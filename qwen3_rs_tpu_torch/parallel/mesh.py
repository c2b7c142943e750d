"""The device mesh of a process group on ``torch.distributed``.

The port of the reference package's ``parallel/mesh.py``.  There a mesh is
one ``jax.sharding.Mesh`` over every device, with named axes ``dp`` (data
parallelism, across hosts) and ``tp`` (tensor parallelism); its pipeline and
sequence-parallel layouts build 1-D meshes on a ``pp`` axis
(``parallel/pipeline.py``) or an ``sp`` axis (``parallel/context.py``).  Here
every rank of a process group is one process on one device, and each builds
its own ``Mesh`` after the process group exists: the same device list and
axes, plus this rank's index, its device and its process group.  A mesh has
one layout: ``{dp, tp}``, ``{pp}`` or ``{sp}``.

A (dp, tp) mesh orders its ranks as the reference's ``reshape(dp, tp)``
does: tp varies fastest, so rank r is replica ``r // tp`` (its dp index)
and shard ``r % tp`` of it (its tp index).  Each replica's tp ranks form a
process subgroup (``tp_group``, the group of its collectives), and so do
the ranks that hold the same shard of every replica (``dp_group``).

The collective backend follows from the device list and is recorded on the
mesh: NCCL when every rank has a card of its own, gloo when ranks share a
card (the one-card counterpart of the reference's virtual CPU mesh) or run
on the CPU.  The serving engine refuses dp > 1, as the reference's does:
serving's data parallelism is one engine per replica.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device

DP_AXIS = "dp"
TP_AXIS = "tp"
PP_AXIS = "pp"
SP_AXIS = "sp"


def backend_for(devices: Sequence[torch.device]) -> str:
    """``nccl`` when the ranks' devices are distinct cards, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index for d in devs if d.type == "cuda"]
    distinct = len(cards) == len(devs) and None not in cards and len(set(cards)) == len(cards)
    return "nccl" if distinct else "gloo"


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (dp, tp), (pp) or (sp) mesh: ``devices`` holds
    one device per rank, in rank order."""

    devices: tuple[torch.device, ...]
    shape: dict
    rank: int = 0
    group: Optional[dist.ProcessGroup] = None
    backend: Optional[str] = None
    # Ranks 1..N-1 as processes of this host, on the rank that started them
    # (``parallel.distributed.launch``); None elsewhere.
    workers: object = None
    # The (dp, tp) layout's subgroups of this rank: its replica's tp ranks
    # (None for a replica of one rank, ``group`` itself where dp = 1) and the
    # ranks holding its shard in every replica (None where dp = 1).
    tp_group: Optional[dist.ProcessGroup] = None
    dp_group: Optional[dist.ProcessGroup] = None

    @property
    def tp(self) -> int:
        return self.shape.get(TP_AXIS, 1)

    @property
    def dp(self) -> int:
        return self.shape.get(DP_AXIS, 1)

    @property
    def tp_index(self) -> int:
        """This rank's shard within its replica."""
        return self.rank % self.tp

    @property
    def dp_index(self) -> int:
        """This rank's replica."""
        return self.rank // self.tp

    def parts(self) -> dict:
        """Each axis of the mesh as ``(size, this rank's index on it)``."""
        if TP_AXIS in self.shape:
            return {DP_AXIS: (self.dp, self.dp_index), TP_AXIS: (self.tp, self.tp_index)}
        ((axis, n),) = self.shape.items()
        return {axis: (n, self.rank)}

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def close(self) -> None:
        """Join the workers this rank started (they leave the group on their
        own), then leave the process group."""
        if self.workers is not None:
            self.workers.join()
            self.workers = None
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()  # the subgroups with it
            self.group = self.tp_group = self.dp_group = None


def create_mesh(
    tp: Optional[int] = None,
    dp: Optional[int] = None,
    devices: Optional[Sequence] = None,
    *,
    pp: Optional[int] = None,
    sp: Optional[int] = None,
) -> Mesh:
    """This rank's mesh over ``devices`` (default: every visible card), all
    on the tp axis unless ``tp``/``dp`` say otherwise; ``pp`` or ``sp`` (the
    device count) makes it a pipeline or sequence-parallel mesh on that one
    axis.  A mesh of more than one device needs the process group of that
    many ranks to exist (``parallel.distributed``); this process's rank is
    its place in ``devices``.  Every rank of the group must call it with the
    same arguments: a (dp, tp) mesh with dp > 1 makes its subgroups, and each
    rank makes every subgroup, in the same order, its own or not."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] or [resolve_device(None)]
    devs = tuple(torch.device(d) for d in devices)
    n = len(devs)
    if pp is not None or sp is not None:
        if tp is not None or dp is not None or (pp is not None and sp is not None):
            raise ValueError("a mesh has one layout: tp (with dp), pp or sp")
        axis, size = (PP_AXIS, pp) if pp is not None else (SP_AXIS, sp)
        if size != n:
            raise ValueError(f"{axis} ({size}) must equal device count ({n})")
        shape = {axis: n}
    else:
        if tp is None and dp is None:
            tp, dp = n, 1
        elif tp is None:
            tp = n // dp
        elif dp is None:
            dp = n // tp
        if dp * tp != n:
            raise ValueError(f"dp ({dp}) × tp ({tp}) must equal device count ({n})")
        shape = {DP_AXIS: dp, TP_AXIS: tp}
    for d in devs:
        resolve_device(d)  # a card that is not there raises here
    if n == 1:
        return Mesh(devs, shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a mesh of {n} devices needs a process group of {n} ranks: start it with "
            "parallel.distributed.initialize_distributed or launch"
        )
    backend = backend_for(devs)
    if dist.get_backend() != backend:
        raise RuntimeError(f"devices {[str(d) for d in devs]} take the {backend} backend, the group runs {dist.get_backend()}")
    mesh = Mesh(devs, shape, rank=dist.get_rank(), group=dist.group.WORLD, backend=backend)
    if TP_AXIS in shape:
        mesh.tp_group, mesh.dp_group = _subgroups(mesh)
    return mesh


def _subgroups(mesh: Mesh):
    """This rank's tp and dp subgroups.  ``dist.new_group`` is collective
    over the whole group: every rank makes every replica's tp group, then
    every shard's dp group, in that order."""
    dp, tp = mesh.dp, mesh.tp
    if dp == 1:
        return (mesh.group if tp > 1 else None), None
    tp_group = dp_group = None
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == mesh.dp_index:
                tp_group = g
    if tp == 1:
        return None, mesh.group
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if t == mesh.tp_index:
            dp_group = g
    return tp_group, dp_group


def single_device_mesh(device=None) -> Mesh:
    return create_mesh(tp=1, dp=1, devices=[resolve_device(device)])
