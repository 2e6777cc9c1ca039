"""The arithmetic of the tensor-core flash-attention kernels, emulated on
the CPU.

``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``
multiply on ``mma.sync``: f32 inputs as 3xTF32 (each operand split as
``big = tf32(x)``, ``small = x - big``, and ``a b = a_small b_big + a_big
b_small + a_big b_big``), bf16 inputs with S (and dP) as exact bf16 products
and the second products (P or dS, f32, times a bf16 tile) as two TF32
passes.  This file repeats that arithmetic in plain PyTorch: TF32 by
masking the low 13 mantissa bits (truncation, which is what the kernel's
split does and what the tensor cores do to any operand, ``small``
included), each pass an f32 product of TF32 values (which the tensor cores
form exactly and sum in f32).  The forward is emulated with its online
softmax over 64-key tiles, so the rescale of the running sums is emulated
too.  It holds the emulated forward and backward against an f64
computation within the f32 gates of the card tests, and shows that a
single TF32 pass misses them.  The emulation lives here, not in the
package.
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

# the card tests' f32 gates (tests/test_torch_flash_attention_cuda.py):
# the backward's, and the forward's on O and LSE
F32_ATOL, F32_RTOL = 2e-4, 1e-4
FWD_ATOL = FWD_RTOL = 1e-4
KEY_TILE = 64  # keys a step of the forward's online softmax
SHAPE = (2, 77, 2, 64)  # ragged: 77 is no multiple of the 64-row tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32 (10 explicit mantissa bits): the low 13 bits
    masked off, as the tensor cores read an f32 register."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x):
    """The kernel's split, as the tensor cores read it: ``small`` is
    ``x - big`` exactly, truncated to TF32 by the hardware."""
    big = tf32(x)
    return big, tf32(x - big)


def product(a, b, passes: int):
    """``a @ b`` (last two dims) the way the kernel forms it: 3 = 3xTF32,
    2 = a split, b used as is (exact in TF32), 1 = one TF32 pass."""
    if passes == 1:
        return tf32(a) @ tf32(b)
    a_big, a_small = split(a)
    if passes == 2:
        return a_small @ b + a_big @ b
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def emulated_forward(q, k, v, causal: bool, passes: int, first_passes: int = None):
    """O and LSE in f32 as the forward kernel computes them, on ``[b, h, L,
    d]`` f32 tensors: S = Q Kᵀ (``first_passes``: 0 is an f32 product, exact
    for bf16-valued inputs) and P V by ``passes``, and the online softmax
    over tiles of ``KEY_TILE`` keys with the TPU kernel's -1e30 mask."""
    first_passes = passes if first_passes is None else first_passes
    scale = 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[2], k.shape[2]
    m = torch.full(q.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    rows = torch.arange(lq)[:, None]
    for k0 in range(0, lk, KEY_TILE):
        kt, vt = k[..., k0:k0 + KEY_TILE, :], v[..., k0:k0 + KEY_TILE, :]
        kt_t = kt.transpose(-1, -2)
        s = q @ kt_t if first_passes == 0 else product(q, kt_t, first_passes)
        keep = (rows >= k0 + torch.arange(kt.shape[2])) if causal else torch.ones(
            lq, kt.shape[2], dtype=torch.bool)
        s = torch.where(keep, s * scale, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new) * keep
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + product(p, vt, passes)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    lse = torch.where(l > 0.0, m + torch.log(l_safe), 0.0)
    return acc / l_safe, lse.squeeze(-1)


def f64_forward(q, k, v, causal: bool):
    s = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), -math.inf)
    return torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1)


def emulated_backward(q, k, v, do, causal: bool, passes: int, first_passes: int = None):
    """dQ, dK, dV in f32 as the kernels compute them, on ``[b, h, L, d]``
    f32 tensors; ``first_passes`` is for S and dP (bf16 inputs: exact)."""
    first_passes = passes if first_passes is None else first_passes
    scale = 1.0 / math.sqrt(q.shape[-1])
    lq, lk = q.shape[2], k.shape[2]
    s = (q.double() @ k.double().transpose(-1, -2)) * scale  # LSE from the forward
    keep = torch.ones(lq, lk, dtype=torch.bool).tril() if causal else torch.ones(lq, lk, dtype=torch.bool)
    lse = torch.logsumexp(s.masked_fill(~keep, -math.inf), -1, keepdim=True).float()
    o = (torch.softmax(s.masked_fill(~keep, -math.inf), -1) @ v.double()).float()
    delta = (do * o).sum(-1, keepdim=True)

    def first(a, b):
        return a @ b.transpose(-1, -2) if first_passes == 0 else product(a, b.transpose(-1, -2),
                                                                          first_passes)

    p = torch.where(keep, torch.exp(first(q, k) * scale - lse), 0.0)
    ds = p * (first(do, v) - delta)
    dq = product(ds, k, passes) * scale
    dk = product(ds.transpose(-1, -2), q, passes) * scale
    dv = product(p.transpose(-1, -2), do, passes)
    return dq, dk, dv


def f64_backward(q, k, v, do, causal: bool):
    q, k, v, do = (t.double().requires_grad_(t is not do) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), -math.inf)
    out = torch.softmax(s, -1) @ v
    return torch.autograd.grad(out, (q, k, v), do)


def _inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, l, h, d = SHAPE
    # [b, h, L, d], the layout of one (batch, head) slice a block reads
    return [torch.from_numpy(rng.standard_normal((b, h, l, d)).astype(np.float32)).to(dtype).float()
            for _ in range(4)]


def test_tf32_truncation_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -10 + 2.0 ** -11)])
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)])
    assert torch.equal(tf32(x), want)
    big, small = split(torch.tensor([math.pi]))
    assert abs(big.item() - math.pi) > 2.0 ** -12 * math.pi  # one TF32 value is not enough
    assert abs((big + small).item() - math.pi) < 2.0 ** -20 * math.pi
    assert tf32(big).item() == big.item() and tf32(small).item() == small.item()


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_forward_meets_the_f32_gate(causal):
    q, k, v, _ = _inputs(torch.float32)
    for got, ref in zip(emulated_forward(q, k, v, causal, passes=3), f64_forward(q, k, v, causal)):
        torch.testing.assert_close(got.double(), ref, atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_single_tf32_pass_forward_misses_the_f32_gate(causal):
    q, k, v, _ = _inputs(torch.float32)
    got = emulated_forward(q, k, v, causal, passes=1)
    for g, ref in zip(got, f64_forward(q, k, v, causal)):
        assert not torch.allclose(g.double(), ref, atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_two_pass_forward_meets_the_f32_gate(causal):
    # bf16 inputs: S exact (bf16 products, f32 sums), P V as two TF32 passes
    # with P kept in f32; held before the final rounding of O to bf16
    q, k, v, _ = _inputs(torch.bfloat16)
    got = emulated_forward(q, k, v, causal, passes=2, first_passes=0)
    for g, ref in zip(got, f64_forward(q, k, v, causal)):
        torch.testing.assert_close(g.double(), ref, atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_backward_meets_the_f32_gate(causal):
    q, k, v, do = _inputs(torch.float32)
    want = f64_backward(q, k, v, do, causal)
    for got, ref in zip(emulated_backward(q, k, v, do, causal, passes=3), want):
        torch.testing.assert_close(got.double(), ref, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_single_tf32_pass_misses_the_f32_gate(causal):
    q, k, v, do = _inputs(torch.float32)
    want = f64_backward(q, k, v, do, causal)
    got = emulated_backward(q, k, v, do, causal, passes=1)
    for g, ref in zip(got, want):
        assert not torch.allclose(g.double(), ref, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_two_pass_second_products_meet_the_f32_gate(causal):
    # bf16 inputs: S and dP exact (bf16 products, f32 sums), the second
    # products as two TF32 passes; held before the final rounding to bf16
    q, k, v, do = _inputs(torch.bfloat16)
    want = f64_backward(q, k, v, do, causal)
    got = emulated_backward(q, k, v, do, causal, passes=2, first_passes=0)
    for g, ref in zip(got, want):
        torch.testing.assert_close(g.double(), ref, atol=F32_ATOL, rtol=F32_RTOL)
