"""Port parity for flash attention's head dims and f16: the plain forward
and backward of ``distkeras_tpu_torch`` at head dims outside the kernels'
built sizes (8, 24, 96, 200) and in f16, against the JAX package's Pallas
kernel run under the Pallas interpreter (``jax.vjp`` for the backward); the
wrappers' zero-padding of the head dim and the scale they pass; and the
refusal above 256.

The kernels are built for head dims 16, 32, 64, 128 and 256; the wrappers
pad any other d up to the next of them and pass ``1/sqrt(d)`` of the true
d.  The kernel path needs a card, so on the CPU the padding test swaps
the three launches for the plain versions at the scale each launch is
given: the result must equal the plain version at the true d.

Tolerances: f32 within 2e-5 (forward) and atol 3e-5 / rtol 3e-4
(backward, as tests/test_torch_flash_attention_bwd.py), summation order
only.  f16: both sides compute in f32 from the same f16 values and round
the result to f16 (11 significant bits): 2e-3 on outputs of size ~1 and
atol 1e-2 / rtol 1e-2 on the gradients.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from distkeras_tpu_torch.ops.flash_attention import (
    HEAD_DIMS,
    attention_delta,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_plain,
    kernel_head_dim,
)

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

# the module (the package's ``ops`` exports a function of the same name)
fa = importlib.import_module("distkeras_tpu_torch.ops.flash_attention")

F32_FWD = dict(atol=2e-5, rtol=2e-5)
F32_BWD = dict(atol=3e-5, rtol=3e-4)
F16_FWD = dict(atol=2e-3, rtol=2e-3)
F16_BWD = dict(atol=1e-2, rtol=1e-2)


def _inputs(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32) for _ in range(4))


def _jax_fwd_and_grads(q, k, v, do, causal, dtype):
    """The interpret-mode Pallas kernels, blocks of 32: output and
    ``(dq, dk, dv)``."""
    args = tuple(jnp.asarray(x, dtype) for x in (q, k, v))
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, causal, 32, 32, True),
                       *args)
    grads = vjp(jnp.asarray(do, dtype))
    return out, [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("d", [8, 24, 96, 200])
def test_plain_matches_pallas_interpret_at_any_head_dim(d):
    causal = d % 16 == 8  # both masks across the four dims
    q, k, v, do = _inputs(d, 1, 40, 2, d)
    out, ref = _jax_fwd_and_grads(q, k, v, do, causal, jnp.float32)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), **F32_FWD)
    grads = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    for got, want in zip(grads, ref):
        np.testing.assert_allclose(got.numpy(), want, **F32_BWD)


def test_plain_f16_matches_pallas_interpret():
    q, k, v, do = _inputs(16, 1, 40, 2, 32)
    out, ref = _jax_fwd_and_grads(q, k, v, do, True, jnp.float16)
    tq, tk, tv, tdo = (torch.from_numpy(x).half() for x in (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, True)
    assert o.dtype == torch.float16 and out.dtype == jnp.float16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(out, np.float32), **F16_FWD)
    grads = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, True)
    for got, want in zip(grads, ref):
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), want, **F16_BWD)


def test_kernel_head_dim_rounds_up_to_a_built_size():
    assert [kernel_head_dim(d) for d in (1, 8, 16, 17, 24, 64, 96, 129, 200, 256)] == \
        [16, 16, 16, 32, 32, 64, 128, 256, 256, 256]
    assert HEAD_DIMS == (16, 32, 64, 128, 256)
    with pytest.raises(ValueError, match="256"):
        kernel_head_dim(257)


@pytest.mark.parametrize("d", [300, 257])
def test_head_dim_above_256_raises(d):
    q = torch.zeros((1, 8, 2, d))
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(q, q, q)


@pytest.fixture
def fake_launches(monkeypatch):
    """The three launches swapped for the plain versions at the scale and
    head dim each is given; records ``(kernel, head dim, scale)``."""
    calls = []

    def fwd(q, k, v, causal, scale):
        calls.append(("fwd", q.shape[3], scale))
        return flash_attention_plain(q, k, v, causal, scale=scale)

    def dq(q, k, v, do, lse, delta, causal, scale):
        calls.append(("dq", q.shape[3], scale))
        return fa._bwd_plain_from_delta(q, k, v, lse, do, delta, causal, scale)[0]

    def dkv(q, k, v, do, lse, delta, causal, scale):
        calls.append(("dkv", q.shape[3], scale))
        return fa._bwd_plain_from_delta(q, k, v, lse, do, delta, causal, scale)[1:]

    monkeypatch.setattr(fa, "_check_launch", lambda **tensors: None)
    monkeypatch.setattr(fa, "_launch_fwd", fwd)
    monkeypatch.setattr(fa, "_launch_dq", dq)
    monkeypatch.setattr(fa, "_launch_dkv", dkv)
    return calls


@pytest.mark.parametrize("d", [8, 24, 96, 200])
def test_padded_kernel_path_passes_the_true_scale(fake_launches, d):
    # the kernel path pads d up to a built size, launches with
    # 1/sqrt(d_true) and slices back: equal to the plain version at d
    q, k, v, do = map(torch.from_numpy, _inputs(d + 1, 2, 24, 2, d))
    o, lse = fa._kernel_fwd(q, k, v, True)
    ref_o, ref_lse = flash_attention_plain(q, k, v, True)
    assert o.shape == q.shape and lse.shape == ref_lse.shape
    torch.testing.assert_close(o, ref_o, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=1e-6)
    delta = attention_delta(o, do)
    got = (flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
           *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))
    for g, want in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do, True)):
        assert g.shape == want.shape
        torch.testing.assert_close(g, want, atol=1e-5, rtol=1e-5)
    built = kernel_head_dim(d)
    assert fake_launches == [(kind, built, 1.0 / math.sqrt(d)) for kind in ("fwd", "dq", "dkv")]


def test_padded_autograd_returns_gradients_of_the_input_shape(fake_launches, monkeypatch):
    # the autograd function on the kernel path at d = 24: the gradients have
    # the inputs' unpadded shape and equal the plain backward's
    monkeypatch.setattr(fa, "flash_attention_fwd",
                        lambda q, k, v, causal=False: fa._kernel_fwd(q, k, v, causal))

    def kernel_bwd(q, k, v, o, lse, do, causal=False):
        delta = attention_delta(o, do)
        return (flash_attention_bwd_dq(q, k, v, do, lse, delta, causal),
                *flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))

    monkeypatch.setattr(fa, "flash_attention_bwd", kernel_bwd)
    q, k, v, do = map(torch.from_numpy, _inputs(3, 1, 20, 2, 24))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.backward(flash_attention(*leaves, True), do)
    o, lse = flash_attention_plain(q, k, v, True)
    for leaf, want in zip(leaves, flash_attention_bwd_plain(q, k, v, o, lse, do, True)):
        assert leaf.grad.shape == (1, 20, 2, 24)
        torch.testing.assert_close(leaf.grad, want, atol=1e-5, rtol=1e-5)
    assert [call[:2] for call in fake_launches] == [("fwd", 32), ("dq", 32), ("dkv", 32)]


def test_cpu_backward_wrapper_takes_any_head_dim():
    q, k, v, do = map(torch.from_numpy, _inputs(5, 1, 16, 2, 40))
    o, lse = flash_attention_plain(q, k, v, False)
    got = flash_attention_bwd(q, k, v, o, lse, do, False)
    for g, want in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, do, False)):
        assert torch.equal(g, want)
