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


def _inputs(shape, lk, dtype, layout):
    """q, k, v and dO for a case of ``FWD_CASES`` or ``BWD_CASES``, on the card."""
    b, lq, h, d = shape
    lk = lq if lk is None else lk
    gen = torch.Generator(device="cuda").manual_seed(0)

    def draw(length, offset=0):
        n = b * length * h * d
        flat = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
        return flat[offset:].view(b, length, h, d)

    if layout == "fused":
        assert lk == lq
        q, k, v = torch.randn((b, lq, 3, h, d), generator=gen,
                              device="cuda").to(dtype).unbind(2)
    else:
        offset = 4 // torch.empty((), dtype=dtype).element_size() if layout == "offset" else 0
        q, k, v = draw(lq, offset), draw(lk, offset), draw(lk, offset)
    do = draw(lq, 2 * offset if layout == "offset" else 0)
    if layout == "offset":
        assert all(t.data_ptr() % 16 for t in (q, k, v, do))
    return q, k, v, do


# (q shape [b, lq, h, d], lk or None for lq, dtype, causal, layout): "fused"
# takes q, k, v as strided views of one QKV projection; "offset" starts every
# input 4 bytes past a 16-byte boundary, which the wrapper must copy first
FWD_CASES = [
    ((2, 100, 2, 32), None, torch.float32, False, "plain"),
    ((2, 100, 2, 32), None, torch.float32, True, "plain"),
    ((1, 257, 4, 128), None, torch.float32, False, "plain"),
    ((2, 130, 3, 16), None, torch.float32, True, "plain"),
    ((2, 192, 2, 64), None, torch.bfloat16, True, "plain"),
    ((2, 200, 3, 64), None, torch.float32, True, "fused"),
    ((2, 130, 3, 16), None, torch.bfloat16, True, "plain"),
    ((2, 100, 2, 32), None, torch.bfloat16, False, "plain"),
    ((1, 257, 4, 128), None, torch.bfloat16, True, "plain"),
    ((1, 200, 2, 128), None, torch.bfloat16, False, "fused"),
    ((2, 63, 2, 64), 130, torch.float32, True, "plain"),
    ((2, 63, 2, 64), 130, torch.float32, False, "plain"),
    ((2, 130, 2, 64), 63, torch.float32, True, "plain"),
    ((2, 130, 2, 64), 63, torch.bfloat16, False, "plain"),
    ((1, 63, 2, 128), 1000, torch.float32, True, "plain"),
    ((1, 1000, 2, 32), 63, torch.bfloat16, True, "plain"),
    ((2, 1, 2, 64), None, torch.float32, True, "plain"),
    ((1, 1, 2, 32), 1000, torch.bfloat16, False, "plain"),
    ((1, 1000, 2, 16), 1, torch.float32, True, "plain"),
    ((2, 100, 2, 64), None, torch.float32, True, "offset"),
    ((2, 100, 2, 32), None, torch.bfloat16, False, "offset"),
]


@pytest.mark.parametrize("shape,lk,dtype,causal,layout", FWD_CASES)
def test_kernel_matches_plain_version_on_card(shape, lk, dtype, causal, layout):
    q, k, v, _ = _inputs(shape, lk, dtype, layout)
    o, lse = flash_attention_fwd(q, k, v, causal)
    ref_o, ref_lse = flash_attention_plain(q, k, v, causal)
    assert flash_attention.launches == 1
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (shape[0], shape[2], shape[1])
    # f32: 3xTF32 and summation order; bf16: O rounded to bf16 at the end
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), ref_o.float(), atol=atol, rtol=1e-4)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3 if dtype == torch.bfloat16 else 1e-4,
                               rtol=1e-4)


def test_forward_kernel_is_deterministic_on_card():
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, _ = _inputs((2, 300, 2, 64), None, dtype, "fused")
        runs = [flash_attention_fwd(q, k, v, True) for _ in range(2)]
        for first, second in zip(*runs):
            assert torch.equal(first, second)


def test_dispatcher_default_launches_the_kernel_for_cuda_tensors():
    q, k, v = _inputs((2, 64, 2, 32), None, torch.float32, "plain")[:3]
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


# backward cases, as FWD_CASES
BWD_CASES = [
    ((2, 100, 2, 32), None, torch.float32, False, "plain"),
    ((2, 100, 2, 32), None, torch.float32, True, "plain"),
    ((1, 257, 4, 128), None, torch.float32, True, "plain"),
    ((2, 130, 3, 16), None, torch.float32, False, "plain"),
    ((2, 192, 2, 64), None, torch.bfloat16, True, "plain"),
    ((2, 200, 3, 64), None, torch.float32, True, "fused"),
    ((2, 130, 3, 16), None, torch.bfloat16, True, "plain"),
    ((2, 100, 2, 32), None, torch.bfloat16, False, "plain"),
    ((1, 257, 4, 128), None, torch.bfloat16, True, "plain"),
    ((2, 1, 2, 64), None, torch.float32, True, "plain"),
    ((2, 63, 2, 64), 65, torch.float32, True, "plain"),
    ((2, 65, 2, 64), 63, torch.bfloat16, True, "plain"),
    ((1, 1000, 2, 64), 63, torch.float32, False, "plain"),
    ((1, 63, 2, 128), 1000, torch.float32, True, "plain"),
    ((1, 1, 2, 32), 1000, torch.bfloat16, False, "plain"),
    ((1, 1000, 2, 16), 1, torch.float32, True, "plain"),
    ((1, 1000, 3, 64), None, torch.float32, True, "plain"),
    ((1, 200, 2, 128), None, torch.float32, True, "fused"),
    ((1, 200, 2, 128), None, torch.bfloat16, False, "fused"),
    ((2, 100, 2, 64), None, torch.float32, True, "offset"),
    ((2, 100, 2, 32), None, torch.bfloat16, False, "offset"),
]


@pytest.mark.parametrize("shape,lk,dtype,causal,layout", BWD_CASES)
def test_backward_kernels_match_plain_version_on_card(shape, lk, dtype, causal, layout):
    q, k, v, do = _inputs(shape, lk, dtype, layout)
    o, lse = flash_attention_plain(q, k, v, causal)
    delta = attention_delta(o, do)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == flash_attention_bwd_dkv.launches == 1
    ref = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    # f32: 3xTF32 and summation order; bf16: gradients rounded to bf16 at the end
    atol, rtol = (3e-2, 2e-2) if dtype == torch.bfloat16 else (2e-4, 1e-4)
    for got, want, like in zip((dq, dk, dv), ref, (q, k, v)):
        assert got.shape == like.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_backward_kernels_are_deterministic_on_card():
    q, k, v, do = _inputs((2, 300, 2, 64), None, torch.float32, "fused")
    o, lse = flash_attention_plain(q, k, v, True)
    delta = attention_delta(o, do)
    runs = [(flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
             *flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)) for _ in range(2)]
    for first, second in zip(*runs):
        assert torch.equal(first, second)


def test_autograd_launches_each_kernel_once_and_matches_plain():
    q, k, v = (t.detach().requires_grad_(True) for t in _inputs((2, 96, 2, 32), None, torch.float32, "plain")[:3])
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
