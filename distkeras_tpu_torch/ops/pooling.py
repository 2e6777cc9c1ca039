"""Max pooling over channels-last tensors.

The port of :mod:`distkeras_tpu.ops.pooling`.  The JAX function takes NHWC
(and NWC) inputs, as flax does, so this one does too.  Non-overlapping
windows with VALID padding over dims that divide evenly (every pool of the
model zoo) take the reshape + ``amax`` path, whose gradient splits a tied
window's gradient evenly over the tied positions, as the JAX fast path's
``reduce_max`` does.  ``F.max_pool2d`` and ``torch.max(dim)`` send it all to
one position instead, and ties are common here: the zoo pools post-ReLU
maps, where exact zeros carry much of the mass.  Every other case
(overlapping windows, SAME or explicit padding, dims that do not divide)
runs ``F.max_pool1d``/``F.max_pool2d`` on a channels-first view, with the
padding applied first as ``-inf``, as flax's ``max_pool`` pads.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["max_pool", "same_padding"]


def same_padding(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial dim: ``(low, high)`` with the
    odd element on the high side (``lax.padtype_to_pads``)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool(
    x: torch.Tensor,
    window_shape: Sequence[int] = (2, 2),
    strides: Optional[Sequence[int]] = None,
    padding="VALID",
) -> torch.Tensor:
    """``flax.linen.max_pool`` over ``x`` laid out ``[batch, *spatial,
    channels]`` (NHWC or NWC).  ``padding`` is ``"VALID"``, ``"SAME"`` or
    one ``(low, high)`` pair per spatial dim."""
    window_shape = tuple(window_shape)
    strides = window_shape if strides is None else tuple(strides)
    spatial = tuple(x.shape[1:-1])
    if len(spatial) != len(window_shape):
        raise ValueError(f"window {window_shape} does not match the {len(spatial)} spatial "
                         f"dims of an input of shape {tuple(x.shape)}")
    if (
        padding == "VALID"
        and strides == window_shape
        and all(s % w == 0 for s, w in zip(spatial, window_shape))
    ):
        shape, axes = [x.shape[0]], []
        for dim, w in zip(spatial, window_shape):
            shape.extend((dim // w, w))
            axes.append(len(shape) - 1)
        shape.append(x.shape[-1])
        return x.reshape(shape).amax(dim=tuple(axes))
    if len(spatial) not in (1, 2):
        raise NotImplementedError(f"max_pool over {len(spatial)} spatial dims")
    if padding == "VALID":
        pads = [(0, 0)] * len(spatial)
    elif padding == "SAME":
        pads = [same_padding(s, w, st) for s, w, st in zip(spatial, window_shape, strides)]
    else:
        pads = [tuple(p) for p in padding]
    channels_first = x.movedim(-1, 1)
    # F.pad orders its pairs from the last dim back
    flat_pads = [p for pair in reversed(pads) for p in pair]
    if any(flat_pads):
        channels_first = F.pad(channels_first, flat_pads, value=float("-inf"))
    pool = F.max_pool1d if len(spatial) == 1 else F.max_pool2d
    return pool(channels_first, window_shape, strides).movedim(1, -1)
