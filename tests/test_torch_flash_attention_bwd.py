"""Port parity: the flash-attention backward of ``distkeras_tpu_torch``
(``flash_attention_bwd_plain`` and the autograd function around the
kernels) against ``jax.vjp`` of the JAX package's Pallas flash attention,
run under the Pallas interpreter as tests/test_pallas_kernels.py runs it.

On the CPU the port's autograd function runs the kernels' plain versions;
the CUDA kernels themselves are held to those plain versions on the card by
tests/test_torch_flash_attention_cuda.py.

Tolerances: f32 gradients within atol 3e-5 / rtol 3e-4 (the JAX package's
own for its kernel against the reference path: summation order only).
bf16 inputs within atol 3e-2 / rtol 2e-2: both sides compute in f32 from
the same bf16 values, but the gradients are rounded to bf16 (8 bits of
mantissa) at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from distkeras_tpu_torch.ops import flash_attention
from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from distkeras_tpu_torch.parallel.ring import local_attention

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

F32 = dict(atol=3e-5, rtol=3e-4)
BF16 = dict(atol=3e-2, rtol=2e-2)


def _inputs(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))


def _jax_grads(q, k, v, do, causal, dtype=jnp.float32):
    """(dq, dk, dv) of the interpret-mode Pallas kernels, blocks of 64."""
    args = tuple(jnp.asarray(x, dtype) for x in (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal, 64, 64, True), *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(do, dtype))]


@pytest.fixture(autouse=True)
def _zero_launches():
    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dkv.launches = 0
    yield


@pytest.mark.parametrize(
    "shape,causal",
    [
        ((2, 64, 2, 32), False),
        ((2, 64, 2, 32), True),
        ((1, 100, 2, 32), False),  # ragged: the JAX side pads to 128
        ((1, 100, 2, 32), True),
        ((1, 64, 2, 64), True),  # head dim 64, the model's
    ],
)
def test_plain_backward_matches_pallas_interpret(shape, causal):
    q, k, v, do = _inputs(0, *shape)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal)
    grads = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for got, want in zip(grads, _jax_grads(q, k, v, do, causal)):
        assert got.dtype == torch.float32 and got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want, **F32)


def test_plain_backward_bfloat16_matches_pallas_interpret():
    q, k, v, do = _inputs(1, 1, 64, 2, 32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, True)
    grads = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, True)
    # the JAX side casts the same bf16-rounded values
    rounded = [x.float().numpy() for x in (tq, tk, tv, tdo)]
    for got, want in zip(grads, _jax_grads(*rounded, True, dtype=jnp.bfloat16)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_pallas_interpret(causal):
    q, k, v, do = _inputs(2, 1, 100, 2, 16)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention(*leaves, causal)
    out.backward(torch.from_numpy(do))
    for leaf, want in zip(leaves, _jax_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(leaf.grad.numpy(), want, **F32)
    # the CPU runs the plain versions: no kernel launched
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (0, 0, 0)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_local_attention(causal):
    q, k, v, do = map(torch.from_numpy, _inputs(3, 2, 40, 2, 16))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*leaves).backward(do)
        return [t.grad for t in leaves]

    got = grads(lambda *a: flash_attention(*a, causal))
    want = grads(lambda *a: local_attention(*a, causal=causal))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32)


def test_stride_zero_output_gradient():
    # out.sum() hands the backward an expanded gradient: every stride 0
    q, k, v, _ = map(torch.from_numpy, _inputs(4, 1, 48, 2, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    flash_attention(*leaves, True).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    local_attention(*ref, causal=True).sum().backward()
    for g, w in zip(leaves, ref):
        torch.testing.assert_close(g.grad, w.grad, **F32)


def test_fused_qkv_views_get_their_gradients():
    # q, k and v as the strided views of one projection, as _SelfAttention
    # makes them: the gradient lands in the one [b, l, 3, h, d] tensor
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 24, 3, 2, 16)).astype(
        np.float32)).requires_grad_(True)
    flash_attention(*qkv.unbind(2), True).pow(2).sum().backward()
    ref = qkv.detach().clone().requires_grad_(True)
    local_attention(*ref.unbind(2), causal=True).pow(2).sum().backward()
    torch.testing.assert_close(qkv.grad, ref.grad, **F32)


def test_backward_wrapper_on_cpu_runs_plain_version():
    q, k, v, do = map(torch.from_numpy, _inputs(6, 1, 32, 2, 16))
    o, lse = flash_attention_plain(q, k, v, False)
    got = flash_attention_bwd(q, k, v, o, lse, do, False)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_kernel_wrappers_refuse_non_cuda_tensors():
    # the CPU takes the plain version through flash_attention_bwd; the
    # kernel wrappers themselves never compute off the card
    q, k, v, do = map(torch.from_numpy, _inputs(7, 1, 16, 2, 16))
    lse = delta = torch.zeros((1, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    assert flash_attention_bwd_dq.launches == flash_attention_bwd_dkv.launches == 0
