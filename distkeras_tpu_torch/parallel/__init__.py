"""Parallel runtime: device resolution, single-device attention and the
windowed training engine."""

from distkeras_tpu_torch.parallel.engine import TrainState, WindowedEngine, plan_workers
from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.parallel.ring import attention, local_attention

__all__ = [
    "TrainState",
    "WindowedEngine",
    "attention",
    "local_attention",
    "plan_workers",
    "resolve_device",
]
