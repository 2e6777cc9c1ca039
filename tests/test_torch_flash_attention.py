"""Port parity: the flash-attention forward of ``distkeras_tpu_torch`` against
the JAX package's Pallas kernel, run under the Pallas interpreter as
tests/test_pallas_kernels.py runs it; and the attention dispatcher.

On the CPU the port's wrapper runs the kernel's plain version; the CUDA
kernel itself is held to that plain version on the card by
tests/test_torch_flash_attention_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.flash_attention import _fa_fwd
from distkeras_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from distkeras_tpu.parallel.ring import local_attention as jax_local_attention
from distkeras_tpu_torch.ops import flash_attention
from distkeras_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain
from distkeras_tpu_torch.parallel.ring import attention, local_attention

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _qkv(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(3))


@pytest.fixture(autouse=True)
def _zero_launches():
    flash_attention.launches = 0
    yield


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [64, 100])  # 100: the ragged edge (JAX pads to 128)
def test_plain_matches_pallas_interpret(causal, l):
    q, k, v = _qkv(0, 2, l, 2, 32)
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_o = np.asarray(jax_flash_attention(jq, jk, jv, causal, 64, 64, True))
    np.testing.assert_allclose(o.numpy(), ref_o, atol=2e-5, rtol=2e-5)
    # the residual LSE is [b*h, 1, padded L]; its first L entries are real rows
    ref_lse = np.asarray(_fa_fwd(jq, jk, jv, causal, 64, 64, True)[1][4])
    ref_lse = ref_lse[:, 0, :l].reshape(2, 2, l)
    assert lse.shape == (2, 2, l) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=2e-5)


def test_plain_bfloat16_matches_pallas_interpret():
    q, k, v = _qkv(1, 1, 64, 2, 32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(jax_flash_attention(jq, jk, jv, True, 64, 64, True), np.float32)
    np.testing.assert_allclose(o.float().numpy(), ref, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_wrapper_on_cpu_runs_plain_version(causal):
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 40, 2, 16))
    o, lse = flash_attention_fwd(q, k, v, causal)
    ref_o, ref_lse = flash_attention_plain(q, k, v, causal)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert torch.equal(flash_attention(q, k, v, causal), ref_o)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_jax(causal):
    q, k, v = _qkv(3, 2, 24, 2, 16)
    out = local_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    ref = jax_local_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_local_attention_segment_ids_match_jax():
    q, k, v = _qkv(4, 2, 16, 2, 16)
    seg = np.repeat(np.array([[1, 2, 3, 0], [1, 1, 2, 2]]), 4, axis=1).astype(np.int32)
    out = local_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          segment_ids=torch.from_numpy(seg))
    ref = jax_local_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_dispatcher_cpu_default_takes_local_attention(causal):
    q, k, v = map(torch.from_numpy, _qkv(5, 2, 24, 2, 16))
    out = attention(q, k, v, causal=causal)
    assert torch.equal(out, local_attention(q, k, v, causal=causal))
    assert flash_attention.launches == 0


def test_dispatcher_use_flash_on_cpu_takes_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(6, 2, 24, 2, 16))
    out = attention(q, k, v, causal=True, use_flash=True)
    assert torch.equal(out, flash_attention_plain(q, k, v, True)[0])
    assert flash_attention.launches == 0


def test_dispatcher_segment_ids_take_local_attention():
    q, k, v = map(torch.from_numpy, _qkv(7, 1, 8, 2, 16))
    seg = torch.tensor([[1, 1, 1, 2, 2, 2, 2, 0]])
    out = attention(q, k, v, causal=True, use_flash=True, segment_ids=seg)
    assert torch.equal(out, local_attention(q, k, v, causal=True, segment_ids=seg))


def test_requires_grad_inputs_are_differentiated():
    # Inputs that require grad are differentiated now (they were refused
    # before the backward kernels existed): the gradient through the
    # wrapper equals the gradient through the reference path, within f32
    # summation order (1e-5), and no kernel launches on the CPU.
    q, k, v = map(torch.from_numpy, _qkv(8, 1, 16, 2, 16))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.sin(flash_attention(*leaves, True)).sum().backward()
    ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.sin(local_attention(*ref, causal=True)).sum().backward()
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, atol=1e-5, rtol=1e-5)
    assert flash_attention.launches == 0
    with torch.no_grad():
        flash_attention(q, k, v)


def test_non_cpu_tensor_goes_to_the_kernel_or_raises():
    # A tensor off the CPU never takes the plain version: here (no card) the
    # launch path refuses a meta tensor instead of computing anything.
    q = torch.empty((1, 16, 2, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, q, q)
    assert flash_attention.launches == 0


@pytest.mark.parametrize(
    "shapes,dtype,error",
    [
        (((1, 16, 2, 24),) * 3, torch.float32, ValueError),      # head dim not built
        (((1, 16, 2, 16),) * 3, torch.float16, TypeError),       # dtype not built
        (((1, 16, 2, 16), (1, 16, 3, 16), (1, 16, 3, 16)), torch.float32, ValueError),
        (((1, 16, 2, 16), (1, 16, 2, 16), (1, 8, 2, 16)), torch.float32, ValueError),
        (((1, 0, 2, 16),) * 3, torch.float32, ValueError),       # empty sequence
        (((16, 2, 16),) * 3, torch.float32, ValueError),         # not 4-D
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtype, error):
    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(error):
        flash_attention(q, k, v)
