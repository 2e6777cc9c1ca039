"""FlashAttention forward: a hand-written CUDA kernel for Hopper.

The port of :mod:`distkeras_tpu.ops.pallas.flash_attention`.  Its one
kernel, ``csrc/flash_attention_fwd.cu``, replaces the Pallas forward kernel
``_fwd_kernel``: tiled online softmax with f32 accumulation whatever the
input dtype, no ``[seq, seq]`` score matrix in device memory, padding and
(optionally) the causal upper triangle masked with -1e30.

Three things live here:

* :func:`flash_attention` / :func:`flash_attention_fwd` — the wrapper.  A
  CUDA tensor launches the kernel (or the call raises); a CPU tensor runs
  :func:`flash_attention_plain`, the counterpart of the JAX kernel's
  interpret mode.  ``flash_attention.launches`` counts kernel launches.
* :func:`flash_attention_plain` — the same function in plain PyTorch, which
  the CPU tests and the on-card comparison use.

Forward only: the backward kernels (dQ, dK/dV) and the autograd function
come with the training slice, so inputs that require grad are refused.
Layout matches the rest of the package: ``[batch, seq, heads, dim]``.
"""

from __future__ import annotations

import math

import torch

from distkeras_tpu_torch.ops import _build

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_fwd", "flash_attention_plain"]

_NEG_BIG = -1e30  # used instead of -inf so fully-masked rows stay NaN-free
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention is forward-only: its backward kernels (dQ, dK/dV) and "
            "autograd function come with the training slice (ROADMAP Queue A, "
            "slice 2: training of the attention models)"
        )


def _launch(q, k, v, causal: bool):
    """Run the CUDA kernel: allocate ``o`` and ``lse`` and launch once."""
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention kernel runs on CUDA tensors, not {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have unit stride in its last (head) dimension")
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lib = _build.flash_attention_fwd_library()
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dk_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, h, lq, lk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: "
            f"{lib.dk_cuda_error_string(err).decode()} (cudaError {err})"
        )
    flash_attention.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = False):
    """Fused attention forward over ``[batch, seq, heads, dim]`` tensors,
    returning ``(o, lse)`` as :func:`flash_attention_plain` does.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    return _launch(q, k, v, causal)


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention ``softmax(Q Kᵀ/√d) V`` over ``[batch, seq, heads,
    dim]`` tensors, semantics as ``parallel.ring.local_attention``."""
    return flash_attention_fwd(q, k, v, causal)[0]


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
