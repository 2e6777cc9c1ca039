"""Device resolution for the port's entry points.

The port of :mod:`distkeras_tpu.parallel.mesh` as far as one card goes:
meshes over several cards come with the multi-GPU slices.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
