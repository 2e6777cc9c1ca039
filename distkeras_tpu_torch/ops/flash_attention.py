"""FlashAttention forward and backward: hand-written CUDA kernels for Hopper.

The port of :mod:`distkeras_tpu.ops.pallas.flash_attention`.  Its three
kernels replace the three Pallas TPU kernels one for one:

* ``csrc/flash_attention_fwd.cu`` — ``_fwd_kernel``: tiled online softmax
  with f32 accumulation whatever the input dtype, no ``[seq, seq]`` score
  matrix in device memory, padding and (optionally) the causal upper
  triangle masked with -1e30;
* ``csrc/flash_attention_bwd.cu`` — ``_dq_kernel`` and ``_dkv_kernel``:
  the FlashAttention-2 backward, recomputing P = exp(S − LSE) blockwise in
  a dQ pass and a dK/dV pass.  Δ = rowsum(dO∘O) is computed outside the
  kernels, as the JAX package does.

All three run their products on the tensor cores: 3xTF32 for f32 inputs
(f32 accuracy), bf16 products then two TF32 passes for bf16 (P and dS stay
f32, as on the TPU).  Their inputs' rows must be 16-byte aligned; the
wrappers copy a tensor whose are not.

What lives here:

* :func:`flash_attention` — the differentiable entry point, a
  ``torch.autograd.Function`` (the counterpart of the JAX ``custom_vjp``):
  its forward runs the forward kernel and saves ``q, k, v, o, lse``; its
  backward runs the two backward kernels.
* :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`,
  :func:`flash_attention_bwd_dkv` — one wrapper per kernel.  A CUDA tensor
  launches the kernel (or the call raises); a CPU tensor runs the plain
  version, the counterpart of the JAX kernels' interpret mode.  Each
  wrapper counts its launches: ``flash_attention.launches`` (forward),
  ``flash_attention_bwd_dq.launches`` and ``flash_attention_bwd_dkv.launches``.
* :func:`flash_attention_plain` and :func:`flash_attention_bwd_plain` — the
  same functions in plain PyTorch, which the CPU tests and the on-card
  comparison use.

Layout matches the rest of the package: ``[batch, seq, heads, dim]``.
"""

from __future__ import annotations

import math

import torch

from distkeras_tpu_torch.ops import _build

__all__ = [
    "HEAD_DIMS",
    "attention_delta",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
]

_NEG_BIG = -1e30  # used instead of -inf so fully-masked rows stay NaN-free
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _causal_mask(lq: int, lk: int, device) -> torch.Tensor:
    """``[lq, lk]`` bool, True where ``row >= col`` (top-left aligned)."""
    return torch.ones(lq, lk, dtype=torch.bool, device=device).tril()


def flash_attention_plain(q, k, v, causal: bool = False):
    """Plain PyTorch flash-attention forward: ``(o, lse)``.

    Computes what the kernel computes, in f32 whatever the input dtype:
    ``o`` ``[b, lq, h, d]`` in the input dtype and ``lse`` ``[b, h, lq]``
    f32 (``m + log l``; 0 for a row with nothing to attend).  The causal
    mask keeps ``row >= col``, aligned at the top-left corner.
    """
    lq, d = q.shape[1], q.shape[3]
    lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(d))
    if causal:
        mask = _causal_mask(lq, lk, q.device)
        s = s.masked_fill(~mask, _NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p * mask
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.transpose(1, 2)
    lse = torch.where(l > 0.0, m + torch.log(l_safe), 0.0).squeeze(-1)
    return o.to(q.dtype), lse


def attention_delta(o, do) -> torch.Tensor:
    """Δ = rowsum(dO∘O) in f32, as a contiguous ``[b, h, lq]`` tensor (the
    layout of the forward's ``lse``)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """Plain PyTorch flash-attention backward: ``(dq, dk, dv)``.

    A direct transcription of the JAX kernels' ``_p_ds`` and their two
    accumulations, in f32 whatever the input dtype: P = exp(S − LSE) where
    the pair is attended and 0 elsewhere, dS = P∘(dP − Δ), dQ = scale·dS·K,
    dK = scale·dSᵀ·Q, dV = Pᵀ·dO.  Each gradient comes back in its input's
    dtype."""
    lq, d = q.shape[1], q.shape[3]
    lk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(lq, lk, q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_delta(o, do)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, dim] tensors")
    b, lq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
            "must agree in batch, heads and head dim, and k and v in length"
        )
    if lq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs non-empty sequences")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported: the kernel is built for {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 inputs of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _check_launch(**tensors):
    """A kernel reads CUDA tensors with unit stride in the head dim."""
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(
                f"the flash-attention kernels run on CUDA tensors, not {t.device}"
            )
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride in its last (head) dimension")


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _aligned(*tensors):
    """Each tensor as is if its rows are 16-byte aligned (the kernels copy
    rows 16 bytes at a time: the data pointer and the batch, seq and head
    strides in bytes must be multiples of 16), else a contiguous copy, which
    a fresh allocation aligns."""
    def aligned(t):
        size = t.element_size()
        return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in _strides(t))

    return tuple(t if aligned(t) else t.clone(memory_format=torch.contiguous_format)
                 for t in tensors)


def _raise_on_error(lib, err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            f"{lib.dk_cuda_error_string(err).decode()} (cudaError {err})"
        )


def _launch(q, k, v, causal: bool):
    """Run the forward kernel: allocate ``o`` and ``lse`` and launch once."""
    _check_launch(q=q, k=k, v=v)
    q, k, v = _aligned(q, k, v)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lib = _build.flash_attention_fwd_library()
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dk_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, lk, d, *_strides(q), *_strides(k), *_strides(v),
            int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d), stream,
        )
    _raise_on_error(lib, err, "flash_attention_fwd")
    flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False):
    """Fused attention forward over ``[batch, seq, heads, dim]`` tensors,
    returning ``(o, lse)`` as :func:`flash_attention_plain` does.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version.
    Not differentiable: :func:`flash_attention` is."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


def _check_bwd_inputs(q, k, v, do, lse, delta):
    """What a backward kernel reads, checked before its pointers are passed."""
    _check_inputs(q, k, v)
    _check_launch(q=q, k=k, v=v, do=do)
    b, lq, h, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, lq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [batch, heads, lq] tensor")
    if not (q.device == do.device == lse.device == delta.device):
        raise ValueError("q, k, v, do, lse and delta must be on one device")


def _bwd_launch(lib, fn, q, k, v, do, lse, delta, causal, *outs):
    q, k, v, do = _aligned(q, k, v, do)
    b, lq, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        return fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
            b, h, lq, k.shape[1], d,
            *_strides(q), *_strides(k), *_strides(v), *_strides(do),
            int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d), stream,
        )


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False):
    """dQ of flash attention (the ``_dq_kernel`` port): ``[b, lq, h, d]`` in
    q's dtype.  ``lse`` is the forward's, ``delta`` is
    :func:`attention_delta`'s.  CUDA tensors only: the CPU computes all
    three gradients at once in :func:`flash_attention_bwd_plain`."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    lib = _build.flash_attention_bwd_library()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bwd_launch(lib, lib.dk_flash_attention_bwd_dq, q, k, v, do, lse, delta, causal, dq)
    _raise_on_error(lib, err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False):
    """dK and dV of flash attention (the ``_dkv_kernel`` port): two
    ``[b, lk, h, d]`` tensors in k's and v's dtype.  CUDA tensors only."""
    _check_bwd_inputs(q, k, v, do, lse, delta)
    lib = _build.flash_attention_bwd_library()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = _bwd_launch(lib, lib.dk_flash_attention_bwd_dkv, q, k, v, do, lse, delta, causal,
                      dk, dv)
    _raise_on_error(lib, err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False):
    """Flash-attention backward: ``(dq, dk, dv)`` from the forward's inputs,
    its output ``o`` and ``lse``, and the output gradient ``do``.

    A CUDA tensor computes Δ and launches the dQ and dK/dV kernels (or the
    call raises); a CPU tensor runs :func:`flash_attention_bwd_plain`.  A
    ``do`` whose head dim is not unit-strided (autograd hands ``out.sum()``
    an expanded, all-zero-stride gradient) is made contiguous first."""
    if q.device.type == "cpu":
        _check_inputs(q, k, v)
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    if do.stride(3) != 1:
        do = do.contiguous()
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} must match q {tuple(q.shape)} {q.dtype}")
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX ``custom_vjp``: the forward kernel, with
    the two backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention ``softmax(Q Kᵀ/√d) V`` over ``[batch, seq, heads,
    dim]`` tensors, semantics as ``parallel.ring.local_attention``, and
    differentiable in ``q``, ``k`` and ``v``."""
    return _FlashAttention.apply(q, k, v, causal)


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
