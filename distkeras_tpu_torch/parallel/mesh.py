"""Device resolution and meshes: the ranks that train one job together.

The port of :mod:`distkeras_tpu.parallel.mesh`.  In JAX a *worker* is a
position along the ``workers`` axis of a ``jax.sharding.Mesh`` of devices
that one program drives.  The port runs **one process per card** (SPMD over
``torch.distributed``, as JAX runs several hosts): a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` over the ranks of the
process group, each rank owns a contiguous block of the logical workers and
holds a replica of the center variable, and the commit's sum over workers
is a local sum over the rank's block followed by an all-reduce over the
mesh's group (ROADMAP Queue C, C10).

Without a process group the port runs on one rank, and :func:`make_mesh`
returns a :class:`LocalMesh`: one rank, no group, no collective.  A run
over N cards is ``torchrun --nproc-per-node N script.py``, or a call to
:func:`distkeras_tpu_torch.networking.initialize` in each process.

Only all-reduce and broadcast run on the training path: they are what
gloo takes for CUDA tensors too, so two ranks can share one card over gloo
(NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "WORKER_AXIS",
    "SEQ_AXIS",
    "LocalMesh",
    "Sharding",
    "all_reduce_sum",
    "barrier",
    "broadcast",
    "local_device_count",
    "make_mesh",
    "make_mesh_grid",
    "mesh_group",
    "mesh_rank",
    "mesh_size",
    "replicated_sharding",
    "resolve_device",
    "worker_sharding",
]

WORKER_AXIS = "workers"
SEQ_AXIS = "seq"

_LAUNCH = ("launch one process per rank: torchrun --nproc-per-node N, or "
           "networking.initialize(address, num_processes, process_id) in each process")


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Entry points default to ``"cuda"``; without a usable card this raises
    rather than carrying on on the CPU, which must be asked for with
    ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(
            f"device {device!r} does not exist: {torch.cuda.device_count()} CUDA device(s)"
        )
    return torch.device("cuda", index)


def _group_ready() -> bool:
    return dist.is_available() and dist.is_initialized()


class LocalMesh:
    """The mesh of a process outside any process group: one rank, every
    dim of size 1, no group, so nothing it drives runs a collective.  It
    answers the few :class:`DeviceMesh` queries the port makes."""

    device_type = "cpu"

    def __init__(self, mesh_dim_names: Sequence[str] = (WORKER_AXIS,)):
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.ndim = len(self.mesh_dim_names)
        self.shape = (1,) * self.ndim

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return f"LocalMesh({self.mesh_dim_names})"


def _device_type() -> str:
    """The DeviceMesh device type of the default group: ``"cuda"`` for
    NCCL, else ``"cpu"`` (gloo moves CUDA tensors through the host)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device_count(device="cuda") -> int:
    """The workers an entry point spreads over by default: the ranks of the
    process group when one exists, else the cards a CUDA device can count
    on (one for the CPU)."""
    if _group_ready():
        return dist.get_world_size()
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def make_mesh(num_workers: Optional[int] = None, axis_name: str = WORKER_AXIS):
    """A 1-D data-parallel mesh over the first ``num_workers`` ranks of the
    process group (every rank by default), its one dim named
    ``axis_name``; a :class:`LocalMesh` when no group exists.  Every rank
    of the group makes the same call.  Asking for more ranks than exist
    raises ``ValueError``, as the JAX package raises past the visible
    devices."""
    world = dist.get_world_size() if _group_ready() else 1
    n = world if num_workers is None else int(num_workers)
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got num_workers={n}")
    if n > world:
        raise ValueError(
            f"num_workers={n} exceeds the ranks of the process group ({world}): {_LAUNCH}"
        )
    if not _group_ready():
        return LocalMesh((axis_name,))
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), list(range(n)), mesh_dim_names=(axis_name,))


def make_mesh_grid(*dims: int, axis_names: tuple = (WORKER_AXIS, SEQ_AXIS)):
    """An N-D mesh, one named dim per entry of ``dims`` over the first
    ``prod(dims)`` ranks, row-major: (workers, seq) for data x sequence
    parallelism.  No engine reads it yet (ring attention over the seq dim
    comes with ROADMAP Queue A item 14)."""
    if len(dims) != len(axis_names):
        raise ValueError(f"{len(dims)} mesh dims for axis names {axis_names}")
    need = 1
    for d in dims:
        need *= int(d)
    world = dist.get_world_size() if _group_ready() else 1
    if need > world:
        raise ValueError(
            f"mesh {'x'.join(map(str, dims))} needs {need} ranks, have {world}: {_LAUNCH}"
        )
    if not _group_ready():
        return LocalMesh(axis_names)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(need).reshape(tuple(int(d) for d in dims))
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=tuple(axis_names))


# ------------------------------------------------------------ mesh queries

def mesh_group(mesh):
    """The process group of a 1-D mesh's dim, or None (no mesh, a
    :class:`LocalMesh`): no collective runs then."""
    return None if mesh is None else mesh.get_group(0)


def mesh_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.size(0))


def mesh_rank(mesh) -> int:
    """This process's rank along the mesh's first dim."""
    return 0 if mesh is None else int(mesh.get_local_rank(0))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leading dim lives on a mesh: split in contiguous blocks over
    the ranks of dim ``split`` (per-worker state and data), or, with
    ``split=None``, whole on every rank (the center variable)."""

    mesh: Any
    split: Optional[str]

    def local_slice(self, n: int) -> slice:
        """The rows of a leading dim of ``n`` this rank holds."""
        if self.split is None:
            return slice(0, n)
        ranks, rank = mesh_size(self.mesh), mesh_rank(self.mesh)
        if n % ranks:
            raise ValueError(f"{n} rows do not split evenly over {ranks} ranks")
        per = n // ranks
        return slice(rank * per, (rank + 1) * per)


def worker_sharding(mesh) -> Sharding:
    """Per-worker state: the leading (workers) dim split over the mesh's
    first dim."""
    return Sharding(mesh, mesh.mesh_dim_names[0])


def replicated_sharding(mesh) -> Sharding:
    """The center variable: whole on every rank."""
    return Sharding(mesh, None)


# ------------------------------------------------------------- collectives

def _comm_device(group, device: torch.device) -> torch.device:
    """Where a collective's buffer must live: NCCL reads the card only."""
    if dist.get_backend(group) == "nccl" and device.type != "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _flat_by_dtype(tensors):
    """``{dtype: (indices, flat buffer)}``: one contiguous buffer per dtype
    so that a collective runs once per dtype, not once per tensor."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return {key: (idx, torch.cat([tensors[i].reshape(-1) for i in idx]))
            for key, idx in groups.items()}


def _unflatten_into(out, tensors, idx, flat) -> None:
    offset = 0
    for i in idx:
        n = tensors[i].numel()
        out[i] = flat[offset:offset + n].view(tensors[i].shape).to(tensors[i].device)
        offset += n


def all_reduce_sum(tensors, group):
    """The elementwise sum of each tensor over the group's ranks, as new
    tensors (the inputs are not written).  One all-reduce per dtype; with
    ``group=None`` the tensors come back as they are."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    out = [None] * len(tensors)
    for (_, device), (idx, flat) in _flat_by_dtype(tensors).items():
        flat = flat.to(_comm_device(group, device))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        _unflatten_into(out, tensors, idx, flat)
    return out


def broadcast(tensors, src: int, group):
    """Each tensor as mesh rank ``src`` holds it, on every rank, as new
    tensors (shapes and dtypes must agree across ranks).  With
    ``group=None`` the tensors come back as they are."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    src_global = dist.get_global_rank(group, src)
    out = [None] * len(tensors)
    for (_, device), (idx, flat) in _flat_by_dtype(tensors).items():
        flat = flat.to(_comm_device(group, device))
        dist.broadcast(flat, src=src_global, group=group)
        _unflatten_into(out, tensors, idx, flat)
    return out


def barrier(group) -> None:
    """Wait for every rank of the group (nothing without one)."""
    if group is not None:
        if dist.get_backend(group) == "nccl":
            dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=group)
