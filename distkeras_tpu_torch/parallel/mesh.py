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

On the data-parallel path only all-reduce and broadcast run: they are
what gloo takes for CUDA tensors too, so two ranks can share one card over
gloo (NCCL refuses two ranks on one card).

**Named axes** (sequence, tensor and pipeline parallelism).  A :func:`make_mesh_grid`
mesh has one process group per axis (``axis_group``); :func:`bind_mesh`
binds a mesh the way JAX's ``shard_map`` binds axis names, and inside it the
differentiable collectives :func:`ppermute`, :func:`all_gather`,
:func:`psum` and :func:`pmean` run over one named axis.  Each is a
``torch.autograd.Function`` whose backward is JAX's transpose (the other
shift; a reduce-scatter; a psum; a pmean) and which keeps its group from
the forward, so the backward needs no binding.  Two more serve compute
that is *replicated* over the axis downstream (tensor parallelism's
column-parallel products, where every rank holds the same whole
cotangent): :func:`gather_from_axis`, a gather whose backward keeps this
rank's block of the cotangent, and :func:`copy_to_axis`, the identity
whose backward is a psum.  The pipeline's :func:`broadcast_from_last` is a
psum whose backward keeps the cotangent on the axis's last rank.  The route is picked by the
group's backend: NCCL's own collectives (ring shifts as one
``batch_isend_irecv``); gloo with CPU tensors directly; gloo with CUDA
tensors staged through pinned host memory for the ring shift and the
gather (gloo's send/recv and gather take no CUDA tensor), while psum and
pmean are :func:`all_reduce_sum`, which gloo copies through the host
itself.  Every byte a collective moves through the host is counted in
:data:`transport_stats` (ROADMAP Queue C, C11).  That staging synchronises
with the card on purpose, so under the runtime sanitizer's transfer guard
it runs as a declared transfer (``transfer.allow("gloo host staging")``),
never as a violation.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from distkeras_tpu_torch.sanitizer import transfer as _transfer

__all__ = [
    "WORKER_AXIS",
    "SEQ_AXIS",
    "TP_AXIS",
    "PP_AXIS",
    "Axis",
    "LocalMesh",
    "Sharding",
    "all_gather",
    "all_reduce_sum",
    "axis_group",
    "axis_index",
    "axis_size",
    "barrier",
    "bind_mesh",
    "bound_mesh",
    "broadcast",
    "broadcast_from_last",
    "copy_to_axis",
    "gather_from_axis",
    "local_device_count",
    "make_mesh",
    "make_mesh_grid",
    "mesh_group",
    "mesh_rank",
    "mesh_size",
    "pmean",
    "ppermute",
    "psum",
    "replicated_sharding",
    "resolve_axis",
    "resolve_device",
    "transport_stats",
    "worker_sharding",
]

WORKER_AXIS = "workers"
SEQ_AXIS = "seq"
#: the tensor-parallel axis of the ``(workers, model)`` grid (the GSPMD engine)
TP_AXIS = "model"
#: the pipeline axis of the ``(workers, stages)`` grid (the pipeline engine)
PP_AXIS = "stages"

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
    parallelism, the grid :class:`~distkeras_tpu_torch.parallel.engine.
    WindowedEngine` builds for ``seq_shards > 1`` (mesh rank ``(w, s)`` is
    global rank ``w * seq_shards + s``), (workers, model) for tensor
    parallelism, the :class:`~distkeras_tpu_torch.parallel.gspmd.GSPMDEngine`'s,
    and (workers, stages) for pipeline parallelism, the
    :class:`~distkeras_tpu_torch.parallel.pipeline.PipelineEngine`'s.  Every
    rank of the process group makes the call; each axis has its own group
    (:func:`axis_group`)."""
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
    ``group=None`` the tensors come back as they are.  gloo takes a CUDA
    tensor here and copies it through the host itself: those bytes count
    in :data:`transport_stats`."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    out = [None] * len(tensors)
    for (_, device), (idx, flat) in _flat_by_dtype(tensors).items():
        flat = flat.to(_comm_device(group, device))
        route = _route(group, flat)
        if route == "host":
            transport_stats["host_staged_bytes"] += 2 * flat.numel() * flat.element_size()
        with _staging(route):
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
        with _staging(_route(group, flat)):
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


# -------------------------------------------------------------- named axes

#: meshes bound by :func:`bind_mesh`, innermost last.  A plain list, not a
#: thread-local: the autograd engine runs a CUDA backward on its own thread,
#: and a rematerialised forward there must see the same binding
_BOUND: list = []

#: bytes the collectives copied between the card and the host (gloo with
#: CUDA tensors; both directions counted); reset it to 0 freely
transport_stats = {"host_staged_bytes": 0}


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind ``mesh`` for the collectives of the block: an axis name given
    to :func:`ppermute` and the others (and to a model's ``seq_axis``)
    resolves against the innermost bound mesh, as a name inside JAX's
    ``shard_map`` resolves against its mesh."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound_mesh():
    """The innermost mesh :func:`bind_mesh` bound, or None."""
    return _BOUND[-1] if _BOUND else None


def _axis_dim(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh axis {axis!r} is not one of the mesh's axes {names}")
    return names.index(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that differ only along ``axis`` and
    share this rank's other coordinates; None on a :class:`LocalMesh`."""
    if mesh is None:
        return None
    return mesh.get_group(_axis_dim(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    if mesh is None:
        return 0
    return int(mesh.get_local_rank(_axis_dim(mesh, axis)))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis`` (``lax.axis_size``)."""
    if mesh is None:
        return 1
    return int(mesh.size(_axis_dim(mesh, axis)))


class Axis(NamedTuple):
    """One named axis of a mesh as this rank sees it: its group (None for
    one rank), this rank's index along it and its size."""

    name: str
    group: Any
    index: int
    size: int


def resolve_axis(axis: str, mesh=None) -> Axis:
    """``axis`` of ``mesh``, or of the bound mesh (:func:`bind_mesh`)."""
    mesh = bound_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError(
            f"mesh axis {axis!r} is not bound: run inside bind_mesh(mesh) (the "
            "engine binds its mesh), as a JAX axis name needs shard_map"
        )
    return Axis(axis, axis_group(mesh, axis), axis_index(mesh, axis), axis_size(mesh, axis))


def _route(group, t: torch.Tensor) -> str:
    """How a collective moves ``t``: ``"nccl"``, ``"direct"``
    (gloo, a CPU tensor) or ``"host"`` (gloo, a CUDA tensor: staged through
    pinned host memory).  Picked by the backend, never by a failed try."""
    if dist.get_backend(group) == "nccl":
        return "nccl"
    return "host" if t.is_cuda else "direct"


def _staging(route: str):
    """The host staging of the ``"host"`` route as a declared transfer to the
    sanitizer's transfer guard (a null context on the other routes, and with
    the sanitizer off)."""
    return _transfer.allow("gloo host staging") if route == "host" else contextlib.nullcontext()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    transport_stats["host_staged_bytes"] += t.numel() * t.element_size()
    return buf


def _from_host(buf: torch.Tensor, device: torch.device) -> torch.Tensor:
    transport_stats["host_staged_bytes"] += buf.numel() * buf.element_size()
    return buf.to(device)


def _shift(flat: torch.Tensor, ax: Axis, shift: int) -> torch.Tensor:
    """``flat`` from the rank ``shift`` places back along the ring, as this
    rank sends its own ``shift`` places on."""
    dst = dist.get_global_rank(ax.group, (ax.index + shift) % ax.size)
    src = dist.get_global_rank(ax.group, (ax.index - shift) % ax.size)
    route = _route(ax.group, flat)
    if route == "nccl":
        out = torch.empty_like(flat)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, flat, dst, ax.group),
                                       dist.P2POp(dist.irecv, out, src, ax.group)])
        for r in reqs:
            r.wait()
        return out
    with _staging(route):
        send = _to_host(flat) if route == "host" else flat
        recv = torch.empty(send.shape, dtype=send.dtype, pin_memory=route == "host")
        reqs = [dist.isend(send, dst, group=ax.group), dist.irecv(recv, src, group=ax.group)]
        for r in reqs:
            r.wait()
        return _from_host(recv, flat.device) if route == "host" else recv


def _gather(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Every rank's ``x`` stacked in axis order: ``[size, *x.shape]``."""
    x = x.contiguous()
    route = _route(ax.group, x)
    if route == "nccl":
        out = torch.empty((ax.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=ax.group)
        return out
    with _staging(route):
        send = _to_host(x) if route == "host" else x
        bufs = [torch.empty_like(send) for _ in range(ax.size)]
        dist.all_gather(bufs, send, group=ax.group)
        out = torch.stack(bufs)
        return _from_host(out, x.device) if route == "host" else out


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the axis, and of it this rank's block along
    ``dim``.  gloo has no reduce-scatter: there it is an all-reduce, then
    the block."""
    block = x.shape[dim] // ax.size
    if _route(ax.group, x) == "nccl":
        chunks = torch.stack(x.split(block, dim=dim)).contiguous()
        out = torch.empty(chunks.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, chunks, op=dist.ReduceOp.SUM, group=ax.group)
        return out
    whole = all_reduce_sum([x], ax.group)[0]
    return whole.narrow(dim, ax.index * block, block).clone()


class _PPermute(torch.autograd.Function):
    """A ring shift of several same-dtype tensors in one transfer."""

    @staticmethod
    def forward(ctx, ax, shift, *tensors):
        ctx.ax, ctx.shift = ax, shift
        ctx.shapes = [t.shape for t in tensors]
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return tuple(p.view(s) for p, s in zip(_shift(flat, ax, shift).split(
            [t.numel() for t in tensors]), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        back = _shift(flat, ctx.ax, -ctx.shift).split([g.numel() for g in grads])
        return (None, None) + tuple(b.view(s) for b, s in zip(back, ctx.shapes))


def ppermute(tensors, axis: str, shift: int = 1, mesh=None):
    """``lax.ppermute`` over ``axis`` with the ring ``i -> i + shift``:
    each tensor as the rank ``shift`` places back holds it.  ``tensors`` is
    a tensor or a sequence of same-dtype tensors, all moved in one
    transfer; the backward shifts the cotangents the other way."""
    ax = resolve_axis(axis, mesh)
    single = isinstance(tensors, torch.Tensor)
    tensors = (tensors,) if single else tuple(tensors)
    if ax.size == 1:
        return tensors[0] if single else tensors
    out = _PPermute.apply(ax, int(shift), *tensors)
    return out[0] if single else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(list(_gather(x, ax).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, _reduce_scatter(g, ctx.ax, ctx.dim)


def all_gather(x: torch.Tensor, axis: str, dim: int = 0, mesh=None) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in axis order.  The backward is JAX's
    transpose, a reduce-scatter (``psum_scatter``): each rank gets the
    sum over ranks of its block of the cotangent."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x
    return _AllGather.apply(ax, dim % x.dim(), x)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, scale, x):
        ctx.ax, ctx.scale = ax, scale
        out = all_reduce_sum([x], ax.group)[0]
        return out if scale == 1 else out / scale

    @staticmethod
    def backward(ctx, g):
        out = all_reduce_sum([g], ctx.ax.group)[0]
        return None, None, out if ctx.scale == 1 else out / ctx.scale


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``lax.psum`` over ``axis``.  Its backward is a psum too, JAX's
    transpose inside ``shard_map``: a replicated loss downstream hands
    each rank ``size`` times its own share of the gradient, which the
    engine's pmean of the gradients turns back into the total."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _PSum.apply(ax, 1, x)


def pmean(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``lax.pmean`` over ``axis``: the psum over the size; the backward
    is a pmean."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _PSum.apply(ax, ax.size, x)


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim, ctx.block = ax, dim, x.shape[dim]
        return torch.cat(list(_gather(x, ax).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, g.narrow(ctx.dim, ctx.ax.index * ctx.block, ctx.block)


def gather_from_axis(x: torch.Tensor, axis: str, dim: int = 0, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order, for a
    computation that continues **replicated** over ``axis``: each rank then
    holds the same whole cotangent, and the backward keeps this rank's block
    of it.  (:func:`all_gather`'s reduce-scatter would sum ``size`` equal
    copies: ``size`` times the gradient.)  Tensor parallelism gathers a
    column-parallel product's outputs, and a split parameter used whole,
    with it."""
    ax = resolve_axis(axis, mesh)
    if ax.size == 1:
        return x
    return _GatherFromAxis.apply(ax, dim % x.dim(), x)


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, all_reduce_sum([g], ctx.ax.group)[0]


def copy_to_axis(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The identity forward and a psum over ``axis`` backward: the
    replicated input of a column-parallel product, whose rank computes the
    outputs of its own block of channels, so that its input's gradient is a
    partial sum over those channels; the psum makes it the whole one."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _CopyToAxis.apply(ax, x)


class _BroadcastFromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ax, x):
        ctx.last = ax.index == ax.size - 1
        return all_reduce_sum([x], ax.group)[0]

    @staticmethod
    def backward(ctx, g):
        return None, g if ctx.last else torch.zeros_like(g)


def broadcast_from_last(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """The last rank's ``x`` along ``axis`` on every rank of it: the psum of
    ``x``, which every other rank passes as zeros.  The backward keeps the
    cotangent on the last rank and hands the others zeros (the JAX
    package's ``_broadcast_from_last``): every rank computes a copy of the
    loss downstream, and a psum's backward would sum all ``size`` copies'
    cotangents, ``size`` times the gradient of the one value there is."""
    ax = resolve_axis(axis, mesh)
    return x if ax.size == 1 else _BroadcastFromLast.apply(ax, x)
