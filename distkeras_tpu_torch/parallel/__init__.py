"""Parallel runtime: device resolution and single-device attention."""

from distkeras_tpu_torch.parallel.mesh import resolve_device
from distkeras_tpu_torch.parallel.ring import attention, local_attention

__all__ = ["attention", "local_attention", "resolve_device"]
