"""torch.distributed multi-process runtime — the MPI replacement;
counterpart of gravit_tpu/parallel/distributed.py.

The reference initializes MPI in gvtInit (api/api.cpp:76-102), sizes the
world via MPI_Comm_size, and moves rays between ranks through the
communicator (core/comm/communicator/scomm.cpp:39-120). The JAX package
writes its schedulers once under shard_map over a mesh axis. Here a mesh
axis is a GROUP, and the schedulers are written once against it. A group
has a `size`, the indices of the members this process holds (`local`), a
`device`, and three collectives, each over the list of the local members'
tensors (in `local` order), returning one tensor per local member:

  all_reduce(xs, op)  the sum ("sum") or the elementwise max ("max")
  all_gather(xs)      the members' tensors stacked on a new leading axis
  all_to_all(xs)      xs[i] is an (size, cap, ...) send buffer; row j of
                      what member k receives is member j's row k (the
                      jax.lax.all_to_all(split_axis=0, concat_axis=0))

Two backends:
  LocalGroup(n, device)  n members in lockstep in ONE process, on one
                         device: the collectives work on the list itself.
                         It stands in for the JAX tests' 8 virtual CPU
                         devices, and puts n > 1 shards on one card.
  DistGroup(pg, device)  one member per process of a torch.distributed
                         process group: gloo on the CPU, NCCL on cards
                         (NCCL puts no two ranks of one communicator on one
                         GPU, so one card holds world size 1 only).
A Mesh names one group per axis: a two-axis layout ("domains", "rays") is
two groups, and a member's place is (domain index, ray index).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gravit_tpu_torch.device import resolve_device

_initialized = False


def _check(group, xs) -> None:
    if len(xs) != len(group.local):
        raise ValueError(f"{type(group).__name__} holds {len(group.local)} "
                         f"local members, got {len(xs)} tensors")


class LocalGroup:
    """`n` members in one process on one device; a collective runs over
    the list of all n members' tensors, summing in member order."""

    def __init__(self, n: int, device=None):
        if n < 1:
            raise ValueError(f"a group needs a member, got {n}")
        self.size = n
        self.local = tuple(range(n))
        self.device = resolve_device(device)

    def all_reduce(self, xs, op: str = "sum"):
        _check(self, xs)
        if op not in ("sum", "max"):
            raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x if op == "sum" else torch.maximum(acc, x)
        return [acc] * self.size

    def all_gather(self, xs):
        _check(self, xs)
        return [torch.stack(list(xs))] * self.size

    def all_to_all(self, xs):
        _check(self, xs)
        sent = torch.stack(list(xs))            # (src, dst, cap, ...)
        return [sent[:, k] for k in range(self.size)]


class DistGroup:
    """This process's member of a torch.distributed process group (the
    world's by default)."""

    def __init__(self, pg=None, device=None):
        if not dist.is_initialized():
            raise RuntimeError("DistGroup needs torch.distributed; call "
                               "parallel.initialize() first")
        self.pg = pg if pg is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.pg)
        self.local = (dist.get_rank(self.pg),)
        self.device = resolve_device(device)

    def all_reduce(self, xs, op: str = "sum"):
        _check(self, xs)
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        out = xs[0].clone()
        dist.all_reduce(out, op=ops[op], group=self.pg)
        return [out]

    def all_gather(self, xs):
        _check(self, xs)
        x = xs[0]
        flat = (x.to(torch.uint8) if x.dtype == torch.bool else x
                ).reshape(-1).contiguous()
        out = torch.empty((self.size * flat.numel(),), dtype=flat.dtype,
                          device=x.device)
        gather = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
        gather(out, flat, group=self.pg)
        out = out.reshape((self.size,) + tuple(x.shape))
        return [out.bool() if x.dtype == torch.bool else out]

    def all_to_all(self, xs):
        _check(self, xs)
        x = xs[0]
        send = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.pg)
        return [out.bool() if x.dtype == torch.bool else out]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The groups of a layout, one per axis name, in axis order; every
    group's members live on `device` in this process."""

    groups: dict

    @property
    def shape(self) -> dict:
        return {a: g.size for a, g in self.groups.items()}

    @property
    def size(self) -> int:
        return math.prod(g.size for g in self.groups.values())

    @property
    def device(self) -> torch.device:
        return next(iter(self.groups.values())).device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """MPI_Init analog (reference api/api.cpp:76-102).

    Arguments left out are read from GRAVIT_COORDINATOR (host:port) /
    GRAVIT_NUM_PROCESSES / GRAVIT_PROCESS_ID. With none of them set this
    runs single-process (mpiexec -n 1). Otherwise it initializes the
    default torch.distributed process group over TCP, NCCL when CUDA is
    present and gloo else (or `backend`); a failure raises. Idempotent.
    """
    global _initialized
    if _initialized:
        return
    coordinator_address = coordinator_address or os.environ.get(
        "GRAVIT_COORDINATOR")
    if num_processes is None and "GRAVIT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["GRAVIT_NUM_PROCESSES"])
    if process_id is None and "GRAVIT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["GRAVIT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        _initialized = True
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs the coordinator's "
                         "address, the process count and this process's id")
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address
    dist.init_process_group(
        backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=coordinator_address, world_size=num_processes,
        rank=process_id)
    _initialized = True


def shutdown() -> None:
    """MPI_Finalize analog."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def process_count() -> int:
    """MPI_Comm_size analog."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """MPI_Comm_rank analog."""
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(axis_names: Sequence[str] = ("domains",),
                shape: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """The groups of a layout over every process (MPI_COMM_WORLD).

    Default shape: (process_count(), 1, ...). One process: a LocalGroup
    per axis, so `shape` may ask for any number of shards on `device`.
    More: one member per process, ranks laid out row-major over `shape`
    (as the JAX package reshapes its device list), and each axis's group
    is the torch.distributed group of the ranks that differ only along it
    (the whole world for a one-axis layout). Every process must call this
    with the same arguments.
    """
    world = process_count()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} does not match axes {axis_names}")
    if world == 1:
        return Mesh({a: LocalGroup(n, device)
                     for a, n in zip(axis_names, shape)})
    if math.prod(shape) != world:
        raise ValueError(f"shape {shape} needs {math.prod(shape)} "
                         f"processes, the world has {world}")
    if len(shape) == 1:
        return Mesh({axis_names[0]: DistGroup(None, device)})
    ranks = np.arange(world).reshape(shape)
    groups = {}
    for k, a in enumerate(axis_names):
        # every process creates every subgroup, in one order
        lines = np.moveaxis(ranks, k, -1).reshape(-1, shape[k])
        mine = None
        for line in lines:
            pg = dist.new_group(ranks=line.tolist())
            if dist.get_rank() in line:
                mine = pg
        groups[a] = DistGroup(mine, device)
    return Mesh(groups)


def host_array(group, local_shards: np.ndarray) -> list:
    """This process's shards on the group's device, one tensor per local
    member: `local_shards` is split evenly along its leading axis (the
    analog of each MPI rank loading only its own domains)."""
    parts = np.array_split(np.asarray(local_shards), len(group.local), axis=0)
    return [torch.as_tensor(p, device=group.device) for p in parts]
