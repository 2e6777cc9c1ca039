"""Single-device attention: the reference path and the dispatcher.

The port of :mod:`distkeras_tpu.parallel.ring`.  Ring attention (sequence
parallelism over several cards) comes with the sequence-parallel slice.
Layout: ``[batch, seq, heads, dim]``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distkeras_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["attention", "local_attention"]


def local_attention(q, k, v, causal: bool = False, segment_ids=None):
    """Reference attention with the same layout (``[batch, seq, heads,
    dim]``): the materialised-scores path, used on the CPU and by tests.

    ``segment_ids`` (``[batch, seq]`` ints, the sequence-packing convention)
    additionally restricts token *i* to keys with the same segment id."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, l, d]
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * (1.0 / math.sqrt(q.shape[-1]))
    if causal or segment_ids is not None:
        lq, lk = s.shape[-2], s.shape[-1]
        mask = torch.ones(lq, lk, dtype=torch.bool, device=s.device)
        if causal:
            mask = mask.tril()
        if segment_ids is not None:
            seg = torch.as_tensor(segment_ids, device=s.device)
            mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
        s = s.masked_fill(~mask, float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vt)
    return out.transpose(1, 2)


def attention(q, k, v, causal: bool = False, use_flash: Optional[bool] = None,
              segment_ids=None):
    """Single-device attention dispatcher (``[batch, seq, heads, dim]``).

    ``use_flash=None`` runs the flash-attention kernel for CUDA tensors and
    :func:`local_attention` for CPU tensors, as the JAX package picks its
    Pallas kernel on the TPU and the reference path elsewhere.
    ``use_flash=True`` on a CPU tensor runs the kernel's plain version.
    ``segment_ids`` (sequence packing) always takes the reference path: the
    kernel has no segment mask.
    """
    if segment_ids is not None:
        return local_attention(q, k, v, causal=causal, segment_ids=segment_ids)
    if use_flash is None:
        use_flash = q.is_cuda
    if use_flash:
        return flash_attention(q, k, v, causal)
    return local_attention(q, k, v, causal=causal)
