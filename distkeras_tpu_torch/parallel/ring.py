"""Attention: the reference path, the dispatcher and ring attention.

The port of :mod:`distkeras_tpu.parallel.ring`.  Layout: ``[batch, seq,
heads, dim]``.

Ring attention (Liu et al., "Ring Attention with Blockwise Transformers",
2023) makes the sequence a shardable dim: the sequence is split in blocks
over a mesh axis, every rank holds one Q/K/V block, and the K/V blocks
rotate around the ring (:func:`~distkeras_tpu_torch.parallel.mesh.
ppermute`) while each rank accumulates its Q block's attention with an
online softmax.  No step materialises the ``[seq, seq]`` scores.  As in the
JAX package, each block's attention is plain products (``_block_attention``;
no kernel runs on the ring), so the flash-attention kernels launch 0 times
on a sequence-parallel path.  The port's differences: K and V move in one
transfer a hop, the hop whose result JAX discards is not made, and a causal
rank does not compute the blocks of later ranks that JAX masks to
``-inf`` (their contribution is exactly zero, so the values are the same).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distkeras_tpu_torch.ops.flash_attention import flash_attention
from distkeras_tpu_torch.parallel.mesh import (
    _gather,
    bind_mesh,
    ppermute,
    resolve_axis,
)

__all__ = ["attention", "local_attention", "ring_attention", "ring_attention_sharded"]


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


def _scale(q: torch.Tensor) -> float:
    """``1 / sqrt(head_dim)`` in ``q``'s dtype, as the JAX ring computes it."""
    return float(1.0 / torch.tensor(float(q.shape[-1]), dtype=q.dtype).sqrt())


def _block_attention(q, k, v, carry, block_mask):
    """One online-softmax accumulation step.

    ``q``: ``[b, h, lq, d]``; ``k``/``v``: ``[b, h, lk, d]``; ``carry =
    (num [b, h, lq, d], den [b, h, lq], m [b, h, lq])``; ``block_mask``: an
    additive ``[lq, lk]`` mask (0 or ``-inf``) or None."""
    num, den, m = carry
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q)
    if block_mask is not None:
        s = s + block_mask
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully masked row gives exp(-inf - -inf): p zeroes it
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    num = num * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    den = den * alpha + p.sum(dim=-1)
    return num, den, m_new


class _KeepInGraph(torch.autograd.Function):
    """``x`` unchanged, with ``deps`` made part of its graph at a zero
    gradient.  A causal rank computes nothing with the K/V blocks of later
    ranks, yet every rank must run the ring's backward shifts, in the same
    order: this makes the last received blocks, and through them every
    hop, reachable from the loss on every rank."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.deps)


def ring_attention(q, k, v, axis_name: str, causal: bool = False, mesh=None):
    """Blockwise ring attention over the mesh axis ``axis_name`` (of
    ``mesh``, or of the mesh :func:`~distkeras_tpu_torch.parallel.mesh.
    bind_mesh` bound).

    Args: this rank's blocks ``[batch, block_len, heads, dim]`` of a
    sequence split in axis order.  Returns this rank's Q block's attention,
    equal up to float association to full attention over the whole
    sequence.  At hop ``t`` a rank holds the K/V block of rank ``(i - t)
    mod n``, accumulated in that order (JAX's); with ``causal`` earlier
    blocks are attended in full, the own block under the causal diagonal,
    later blocks not at all."""
    ax = resolve_axis(axis_name, mesh)
    n, my = ax.size, ax.index
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, l, d]
    b, h, lq, d = qt.shape
    lk = kt.shape[2]
    carry = (qt.new_zeros((b, h, lq, d)), qt.new_zeros((b, h, lq)),
             qt.new_full((b, h, lq), float("-inf")))
    diag = None
    if causal:
        tri = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        diag = torch.zeros(lq, lk, dtype=q.dtype, device=q.device).masked_fill(~tri, float("-inf"))
    k_cur, v_cur = kt, vt
    for t in range(n):
        src = (my - t) % n
        if not causal or src < my:  # JAX adds a mask of zeros here: no change
            carry = _block_attention(qt, k_cur, v_cur, carry, None)
        elif src == my:
            carry = _block_attention(qt, k_cur, v_cur, carry, diag)
        if t < n - 1:  # the last hop's blocks would go unused
            k_cur, v_cur = ppermute((k_cur, v_cur), axis_name, 1, mesh)
    num, den, _ = carry
    if n > 1:
        num = _KeepInGraph.apply(num, k_cur, v_cur)
    out = num / torch.where(den == 0, 1.0, den)[..., None]
    return out.transpose(1, 2)


class _TakeBlock(torch.autograd.Function):
    """This rank's block of a tensor replicated over the axis; the backward
    gathers every rank's block cotangent, so the replicated input gets its
    whole gradient on every rank."""

    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        block = x.shape[dim] // ax.size
        return x.narrow(dim, ax.index * block, block).clone()

    @staticmethod
    def backward(ctx, g):
        return None, None, torch.cat(list(_gather(g, ctx.ax).unbind(0)), dim=ctx.dim)


class _GatherBlocks(torch.autograd.Function):
    """The blocks of every rank, concatenated, as a tensor replicated over
    the axis; the backward keeps this rank's block of the (replicated)
    cotangent."""

    @staticmethod
    def forward(ctx, ax, dim, x):
        ctx.ax, ctx.dim = ax, dim
        return torch.cat(list(_gather(x, ax).unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        block = g.shape[ctx.dim] // ctx.ax.size
        return None, None, g.narrow(ctx.dim, ctx.ax.index * block, block).clone()


def ring_attention_sharded(q, k, v, mesh, axis_name: Optional[str] = None,
                           causal: bool = False):
    """:func:`ring_attention` on global ``[batch, seq, heads, dim]``
    tensors, the same on every rank of the axis (JAX's global arrays, with
    the sequence sharded over ``axis_name``, the mesh's first axis by
    default): each rank takes its block, runs the ring and gathers the
    output, so every rank returns the whole output, and a gradient taken
    through it is the whole gradient on every rank."""
    axis_name = axis_name or mesh.mesh_dim_names[0]
    ax = resolve_axis(axis_name, mesh)
    if ax.size == 1:
        return ring_attention(q, k, v, axis_name, causal, mesh)
    if q.shape[1] % ax.size or k.shape[1] % ax.size:
        raise ValueError(f"sequence {q.shape[1]} does not split evenly over {ax.size} ranks")
    blocks = [_TakeBlock.apply(ax, 1, x) for x in (q, k, v)]
    with bind_mesh(mesh):
        out = ring_attention(*blocks, axis_name, causal)
    return _GatherBlocks.apply(ax, 1, out)
