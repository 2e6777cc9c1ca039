"""The port's flash-attention CUDA kernels (forward, dQ, dK/dV) against their
plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports torch and the port only, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_cuda.py -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerClassifier
from distkeras_tpu_torch.ops import flash_attention
from distkeras_tpu_torch.ops.flash_attention import (
    attention_delta,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from distkeras_tpu_torch.parallel.ring import attention

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    flash_attention.launches = 0
    flash_attention_bwd_dq.launches = 0
    flash_attention_bwd_dkv.launches = 0
    yield


def _qkv(shape, dtype, fused=False):
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, l, h, d = shape
    if fused:  # strided views of one QKV projection, as _SelfAttention makes them
        return torch.randn((b, l, 3, h, d), generator=gen, device="cuda").to(dtype).unbind(2)
    return tuple(torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))


@pytest.mark.parametrize(
    "shape,dtype,causal,fused",
    [
        ((2, 100, 2, 32), torch.float32, False, False),
        ((2, 100, 2, 32), torch.float32, True, False),
        ((1, 257, 4, 128), torch.float32, False, False),
        ((2, 130, 3, 16), torch.float32, True, False),
        ((2, 192, 2, 64), torch.bfloat16, True, False),
        ((2, 200, 3, 64), torch.float32, True, True),
    ],
)
def test_kernel_matches_plain_version_on_card(shape, dtype, causal, fused):
    q, k, v = _qkv(shape, dtype, fused)
    o, lse = flash_attention_fwd(q, k, v, causal)
    ref_o, ref_lse = flash_attention_plain(q, k, v, causal)
    assert flash_attention.launches == 1
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (shape[0], shape[2], shape[1])
    # f32: summation order only; bf16: O rounded to bf16 at the end
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), ref_o.float(), atol=atol, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
                               rtol=1e-4)


def test_dispatcher_default_launches_the_kernel_for_cuda_tensors():
    q, k, v = _qkv((2, 64, 2, 32), torch.float32)
    out = attention(q, k, v, causal=True)
    assert flash_attention.launches == 1
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, True)[0], atol=1e-4, rtol=1e-4)


def test_classifier_on_card_launches_once_per_layer_and_matches_cpu():
    cfg = dict(vocab_size=64, num_classes=3, dim=64, heads=2, num_layers=2, max_len=64)
    model = TransformerClassifier(**cfg, generator=torch.Generator().manual_seed(0))
    params = {name: p.detach() for name, p in model.named_parameters()}
    tokens = np.random.default_rng(0).integers(0, 64, (4, 48), dtype=np.int32)
    on_card = TrainedModel(TorchModel(model), params, device="cuda")(tokens)
    assert flash_attention.launches == cfg["num_layers"]
    on_cpu = TrainedModel(TorchModel(model), params, device="cpu")(tokens)
    torch.testing.assert_close(on_card.cpu(), on_cpu, atol=1e-4, rtol=1e-4)


BWD_CASES = [
    ((2, 100, 2, 32), torch.float32, False, False),
    ((2, 100, 2, 32), torch.float32, True, False),
    ((1, 257, 4, 128), torch.float32, True, False),
    ((2, 130, 3, 16), torch.float32, False, False),
    ((2, 192, 2, 64), torch.bfloat16, True, False),
    ((2, 200, 3, 64), torch.float32, True, True),
]


@pytest.mark.parametrize("shape,dtype,causal,fused", BWD_CASES)
def test_backward_kernels_match_plain_version_on_card(shape, dtype, causal, fused):
    q, k, v = _qkv(shape, dtype, fused)
    gen = torch.Generator(device="cuda").manual_seed(1)
    do = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    o, lse = flash_attention_plain(q, k, v, causal)
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == flash_attention_bwd_dkv.launches == 1
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    # f32: summation order only; bf16: gradients rounded to bf16 at the end
    atol, rtol = (3e-2, 2e-2) if dtype == torch.bfloat16 else (2e-4, 1e-4)
    for got, want in zip((dq, dk, dv), ref):
        assert got.shape == want.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_autograd_launches_each_kernel_once_and_matches_plain():
    q, k, v = (t.detach().requires_grad_(True) for t in _qkv((2, 96, 2, 32), torch.float32))
    out = flash_attention(q, k, v, True)
    out.sum().backward()  # an all-zero-stride output gradient
    assert (flash_attention.launches, flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (1, 1, 1)
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), True)
    ref = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse,
                                    torch.ones_like(o), True)
    for leaf, want in zip((q, k, v), ref):
        torch.testing.assert_close(leaf.grad, want, atol=2e-4, rtol=1e-4)


def test_lm_training_step_on_card_matches_cpu():
    from distkeras_tpu_torch.models import TransformerLM
    from distkeras_tpu_torch.ops import get_loss

    cfg = dict(vocab_size=64, dim=64, heads=2, num_layers=2, max_len=64)
    model = TransformerLM(**cfg, generator=torch.Generator().manual_seed(0))
    adapter = TorchModel(model)
    params = {name: p.detach() for name, p in model.named_parameters()}
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 48)))
    labels = (tokens + 1) % 64
    loss_fn = get_loss("token_crossentropy")

    def step(device):
        leaves = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        out, _ = adapter.apply(leaves, {}, tokens.to(device), training=True)
        loss = loss_fn(out, labels.to(device))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), [g.cpu() for g in grads]

    loss_card, grads_card = step("cuda")
    assert flash_attention_bwd_dq.launches == flash_attention_bwd_dkv.launches == 2
    loss_cpu, grads_cpu = step("cpu")
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for g_card, g_cpu in zip(grads_card, grads_cpu):
        assert (g_card - g_cpu).norm() <= 1e-3 * g_cpu.norm() + 1e-8
