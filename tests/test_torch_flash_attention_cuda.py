"""The port's flash-attention CUDA kernel against its plain PyTorch version,
on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports torch and the port only, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_cuda.py -q
"""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerClassifier
from distkeras_tpu_torch.ops import flash_attention
from distkeras_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_plain
from distkeras_tpu_torch.parallel.ring import attention

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    flash_attention.launches = 0
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
