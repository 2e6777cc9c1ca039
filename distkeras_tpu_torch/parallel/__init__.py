"""Parallel runtime: device resolution, meshes over the ranks of a process
group, single-device attention and the windowed training engine."""

from distkeras_tpu_torch.parallel.engine import TrainState, WindowedEngine, plan_workers
from distkeras_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    WORKER_AXIS,
    LocalMesh,
    local_device_count,
    make_mesh,
    make_mesh_grid,
    replicated_sharding,
    resolve_device,
    worker_sharding,
)
from distkeras_tpu_torch.parallel.ring import attention, local_attention

__all__ = [
    "SEQ_AXIS",
    "WORKER_AXIS",
    "LocalMesh",
    "TrainState",
    "WindowedEngine",
    "attention",
    "local_attention",
    "local_device_count",
    "make_mesh",
    "make_mesh_grid",
    "plan_workers",
    "replicated_sharding",
    "resolve_device",
    "worker_sharding",
]
