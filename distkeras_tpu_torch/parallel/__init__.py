"""Parallel runtime: device resolution, meshes over the ranks of a process
group and their named-axis collectives, attention (single-device and ring),
the windowed training engine, the GSPMD engine (tensor parallelism and
the workers-axis ZeRO center) and the pipeline engine (pipeline
parallelism)."""

from distkeras_tpu_torch.parallel.engine import (
    TrainState,
    WindowedEngine,
    plan_workers,
    zero_shard_dim,
)
from distkeras_tpu_torch.parallel.gspmd import TP_AXIS, GSPMDEngine, default_tp_dim
from distkeras_tpu_torch.parallel.pipeline import PP_AXIS, PipelineEngine
from distkeras_tpu_torch.parallel.mesh import (
    SEQ_AXIS,
    WORKER_AXIS,
    LocalMesh,
    bind_mesh,
    local_device_count,
    make_mesh,
    make_mesh_grid,
    replicated_sharding,
    resolve_device,
    worker_sharding,
)
from distkeras_tpu_torch.parallel.ring import (
    attention,
    local_attention,
    ring_attention,
    ring_attention_sharded,
)

__all__ = [
    "PP_AXIS",
    "SEQ_AXIS",
    "TP_AXIS",
    "WORKER_AXIS",
    "GSPMDEngine",
    "LocalMesh",
    "PipelineEngine",
    "TrainState",
    "WindowedEngine",
    "attention",
    "bind_mesh",
    "default_tp_dim",
    "local_attention",
    "local_device_count",
    "make_mesh",
    "make_mesh_grid",
    "plan_workers",
    "replicated_sharding",
    "resolve_device",
    "ring_attention",
    "ring_attention_sharded",
    "worker_sharding",
    "zero_shard_dim",
]
