"""Process groups, device meshes and distributed initialization.

Counterpart of ``sdag_tpu/core/mesh.py``.  The JAX package is one process
driving many devices; this port is SPMD: each rank is one process on one
device, launched by ``torchrun`` (``python -m torch.distributed.run``).
Axes, as in the JAX package:

- ``data``  : batch/data parallelism (queries, generation batches)
- ``model`` : tensor parallelism inside the decoder
- ``index`` : corpus-row sharding for the dense/sparse indexes (one
  dimension over all ranks)
- ``pipe``  : GPipe stages of a training step (``make_pipe_mesh``), alone
  or beside ``model``

A ``Mesh`` names this rank's place on each axis and the process group of
the ranks it shares that axis with.  Without a process group (``WORLD_SIZE``
unset) every mesh has one rank, its groups are None and the collectives of
``parallel/collectives.py`` are the identity, as JAX's ``psum`` over an
axis of size 1 is.  A ``data x model`` mesh smaller than the world is laid
over it as replicas, each computing the same results (the JAX package
leaves the devices past the mesh idle; here every rank must take part).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from sdag_tpu_torch.utils.device import resolve_device

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


def maybe_init_distributed(device=None, backend: Optional[str] = None
                           ) -> bool:
    """Initialize the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Returns False when none is set (one process, no
    group), True once the group exists.  Raises when only some are set:
    a rank without its id or address would hang the others at the first
    collective.  ``backend``: NCCL for a CUDA device, gloo else."""
    present = [v for v in _TORCHRUN_VARS if os.environ.get(v)]
    if not present:
        return False
    if dist.is_initialized():
        return True
    if len(present) != len(_TORCHRUN_VARS):
        missing = sorted(set(_TORCHRUN_VARS) - set(present))
        raise ValueError(
            f"torchrun environment is incomplete: {', '.join(missing)} "
            "unset; every process must export RANK, WORLD_SIZE, LOCAL_RANK, "
            "MASTER_ADDR and MASTER_PORT")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                              f"{os.environ['MASTER_PORT']}"),
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when given, else ``cuda:LOCAL_RANK``
    under torchrun and ``cuda`` without it."""
    if device is not None:
        return resolve_device(device)
    if os.environ.get("LOCAL_RANK"):
        return resolve_device(f"cuda:{int(os.environ['LOCAL_RANK'])}")
    return resolve_device("cuda")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Rank 0 writes results and index files; the other ranks compute the
    same and write nothing."""
    return world_rank() == 0


class Mesh:
    """This rank's place on a mesh: ``shape`` (axis -> size), ``coords``
    (axis -> this rank's index on it) and ``groups`` (axis -> the process
    group along it, None without a process group)."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int],
                 groups: Dict[str, Optional[dist.ProcessGroup]],
                 device: torch.device) -> None:
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.groups = dict(groups)
        self.device = device

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def mesh_shape(data: int, model: int, n: int):
    """(data, model) of a ``make_mesh`` call over ``n`` ranks, the JAX
    package's rules: model <= 0 means 1, data <= 0 fills the world."""
    model = max(model, 1)
    if data <= 0:
        data = max(1, n // model)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data*model} devices, "
                         f"have {n} (torch.distributed world size {n})")
    if n % (data * model):
        raise ValueError(f"mesh {data}x{model} does not tile the "
                         f"torch.distributed world size {n}: every rank "
                         "needs a place on a replica of the mesh")
    return data, model


# this rank's (data, model) groups by mesh shape, for the current default
# group: a mesh asked for again reuses its communicators
_GROUPS: Dict[tuple, Dict[str, Optional[dist.ProcessGroup]]] = {}
_GROUPS_WORLD: list = [None]


def release_mesh_groups() -> None:
    """Forget the cached groups; call before destroying the default group,
    so no group object outlives it (one left to interpreter exit is torn
    down after the backend it needs)."""
    _GROUPS.clear()
    _GROUPS_WORLD[0] = None


def _mesh_groups(data: int, model: int, n: int, rep: int, coords
                 ) -> Dict[str, Optional[dist.ProcessGroup]]:
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    key = (data, model, n)
    if key in _GROUPS:
        return _GROUPS[key]
    size = data * model
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    # every rank creates every group, in one order (new_group's rule)
    for r in range(n // size):
        base = r * size
        for di in range(data):
            g = dist.new_group([base + di * model + mi
                                for mi in range(model)])
            if r == rep and di == coords["data"]:
                groups["model"] = g
        for mi in range(model):
            g = dist.new_group([base + di * model + mi
                                for di in range(data)])
            if r == rep and mi == coords["model"]:
                groups["data"] = g
    _GROUPS[key] = groups
    return groups


def make_mesh(data: int = 0, model: int = 1, device=None) -> Mesh:
    """2D compute mesh ('data', 'model') over the world's ranks, rank =
    replica * data * model + data_index * model + model_index.  The
    process groups of a shape are made once per default group."""
    n, me = world_size(), world_rank()
    data, model = mesh_shape(data, model, n)
    rep, local = divmod(me, data * model)
    coords = {"data": local // model, "model": local % model}
    groups = (_mesh_groups(data, model, n, rep, coords)
              if dist.is_initialized() else {"data": None, "model": None})
    return Mesh({"data": data, "model": model}, coords, groups,
                rank_device(device))


def make_pipe_mesh(pipe: int, model: int = 1, device=None) -> Mesh:
    """Pipeline mesh ('pipe', 'model') for GPipe training
    (``parallel/pipeline.py``): ``pipe`` stages, each Megatron-split over
    ``model`` ranks (1: the stage is whole), rank = replica * pipe * model
    + stage * model + model_index (the JAX tests' ``reshape(pipe,
    model)`` of the device list).  A stage's ranks form the 'model'
    group; the ranks of one model index along the stages the 'pipe'
    group, which carries the activations and the replicated leaves'
    gradient sums."""
    n, me = world_size(), world_rank()
    pipe, model = mesh_shape(pipe, model, n)
    rep, local = divmod(me, pipe * model)
    coords = {"data": local // model, "model": local % model}
    groups = ({"data": None, "model": None} if not dist.is_initialized()
              else _mesh_groups(pipe, model, n, rep, coords))
    return Mesh({"pipe": pipe, "model": model},
                {"pipe": coords["data"], "model": coords["model"]},
                {"pipe": groups["data"], "model": groups["model"]},
                rank_device(device))


def make_index_mesh(device=None) -> Mesh:
    """1D mesh over all ranks for corpus-row sharding."""
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh({"index": world_size()}, {"index": world_rank()},
                {"index": group}, rank_device(device))


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str = "index"
               ) -> torch.Tensor:
    """This rank's block of x's rows along ``axis`` of ``mesh``, on the
    mesh's device (rows must divide the axis size)."""
    n = mesh.shape[axis]
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not divide the {axis} axis "
                         f"size {n}")
    rows = x.shape[0] // n
    r = mesh.rank(axis)
    return x[r * rows:(r + 1) * rows].to(mesh.device).contiguous()


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.to(mesh.device)
