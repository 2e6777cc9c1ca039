"""Port parity: the model zoo (``distkeras_tpu_torch.models.zoo``) and
``ops.pooling.max_pool`` against the JAX package's flax models and pool.

Both sides start from one flax initialisation, carried over by
``variables_from_flax``; inputs come from numpy with a seed.  Tolerances:
f32 logits within atol 1e-4 (summation order only), BatchNorm running
statistics within 1e-5, the pool's forward and tied gradient exact (0
error: a max and an even split of the gradient), bf16 logits within 2e-2
(both round activations to bf16, at other places).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jax_zoo
from distkeras_tpu.ops.pooling import max_pool as jax_max_pool
from distkeras_tpu_torch.models import TorchModel, variables_from_flax, zoo
from distkeras_tpu_torch.ops import max_pool

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

LOGIT_ATOL = 1e-4
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 2e-2

TEXT = dict(vocab_size=50, embed_dim=8, filters=4)


def _models(rng):
    """(name, flax model, port model, input) at small sizes; CIFARCNN and
    MNISTCNN keep their input sizes, which their Dense layers fix."""
    return {
        "mlp": (jax_zoo.MLP(features=(16, 8)), zoo.MLP(features=(16, 8), in_features=12),
                rng.normal(size=(3, 12)).astype(np.float32)),
        "mnist_cnn": (jax_zoo.MNISTCNN(), zoo.MNISTCNN(),
                      rng.normal(size=(3, 784)).astype(np.float32)),
        "cifar_cnn": (jax_zoo.CIFARCNN(), zoo.CIFARCNN(),
                      rng.normal(size=(3, 32, 32, 3)).astype(np.float32)),
        "cifar_cnn_flat": (jax_zoo.CIFARCNN(), zoo.CIFARCNN(),
                           rng.normal(size=(3, 32 * 32 * 3)).astype(np.float32)),
        "resnet20": (jax_zoo.ResNet20(), zoo.ResNet20(),
                     rng.normal(size=(3, 8, 8, 3)).astype(np.float32)),
        "text_cnn": (jax_zoo.TextCNN(**TEXT), zoo.TextCNN(**TEXT),
                     rng.integers(0, 50, size=(3, 10)).astype(np.int32)),
    }


def _port_apply(module, params, buffers, x, training=False):
    state = {k: v.clone() for k, v in buffers.items()}
    out, state = TorchModel(module).apply(params, state, torch.from_numpy(x), training=training)
    return out, state


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["mlp", "mnist_cnn", "cifar_cnn", "cifar_cnn_flat",
                                  "resnet20", "text_cnn"])
def test_forward_matches_flax(name, training):
    jax_model, model, x = _models(np.random.default_rng(0))[name]
    variables = jax_model.init(jax.random.PRNGKey(1), x, training=False)
    params, buffers = variables_from_flax(model, variables)
    if training and "batch_stats" in variables:
        want, _ = jax_model.apply(variables, x, training=True, mutable=["batch_stats"])
    else:
        want = jax_model.apply(variables, x, training=training)
    got, _ = _port_apply(model, params, buffers, x, training)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def test_resnet20_running_stats_match_flax():
    # two training steps: pins flax's momentum 0.9 and its biased variance
    rng = np.random.default_rng(2)
    batches = [rng.normal(loc=0.5, size=(4, 8, 8, 3)).astype(np.float32) for _ in range(2)]
    jax_model, model = jax_zoo.ResNet20(), zoo.ResNet20()
    variables = jax_model.init(jax.random.PRNGKey(3), batches[0], training=False)
    params, buffers = variables_from_flax(model, variables)
    stats = variables["batch_stats"]
    for x in batches:
        _, upd = jax_model.apply({"params": variables["params"], "batch_stats": stats}, x,
                                 training=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
        _, buffers = _port_apply(model, params, buffers, x, training=True)
    _, want = variables_from_flax(zoo.ResNet20(), {"params": variables["params"],
                                                  "batch_stats": stats})
    assert buffers.keys() == want.keys() and len(want) == 2 * 19
    for k in want:
        np.testing.assert_allclose(buffers[k].numpy(), want[k].numpy(), **STATS_TOL, err_msg=k)
    # the statistics moved from their init (zeros and ones)
    assert float(buffers["stem_bn.running_mean"].abs().max()) > 1e-3


def _tied_input():
    # post-ReLU-like values on a coarse grid: many exact ties in each window
    rng = np.random.default_rng(4)
    return np.maximum(rng.integers(-2, 3, size=(2, 4, 6, 3)), 0).astype(np.float32)


def test_max_pool_fast_path_forward_and_tied_gradient_match_jax():
    x = _tied_input()
    cot = np.random.default_rng(5).normal(size=(2, 2, 3, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_max_pool(a, (2, 2)), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = max_pool(xt, (2, 2))
    (got_grad,) = torch.autograd.grad(got, xt, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_grad.numpy(), np.asarray(want_grad))
    # ties split the gradient: some position receives a fraction of its cotangent
    assert np.any((got_grad.numpy() != 0) & (np.abs(got_grad.numpy()) < np.abs(cot).max()))


@pytest.mark.parametrize(
    "shape, window, strides, padding",
    [((2, 5, 7, 3), (2, 2), (2, 2), "VALID"),   # dims that do not divide
     ((2, 6, 6, 3), (3, 3), (2, 2), "VALID"),   # overlapping windows
     ((2, 5, 6, 3), (3, 3), (2, 2), "SAME"),    # SAME, odd pad on the high side
     ((2, 6, 6, 3), (2, 2), (1, 1), ((0, 1), (1, 0))),
     ((2, 9, 4), (3,), (2,), "SAME")],           # NWC
    ids=["ragged", "overlap", "same", "explicit", "nwc"],
)
def test_max_pool_fallback_matches_flax(shape, window, strides, padding):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(x), window, strides=strides, padding=padding)
    got = max_pool(torch.from_numpy(x), window, strides=strides, padding=padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "size, kernel, strides",
    [((8, 8), (3, 3), 2), ((7, 7), (3, 3), 2), ((8, 8), (1, 1), 2), ((10,), (4,), 1),
     ((9,), (5,), 1)],
    ids=["stride2_even", "stride2_odd", "proj_1x1", "even_kernel_1d", "odd_kernel_1d"],
)
def test_same_conv_padding_matches_flax(size, kernel, strides):
    # flax pads SAME with the odd element on the high side: (0, 1) for the
    # stride-2 3x3 conv over 8, (1, 2) for TextCNN's width-4 kernel
    x = np.random.default_rng(7).normal(size=(2, *size, 3)).astype(np.float32)
    flax_conv = fnn.Conv(5, kernel, strides=strides)
    variables = flax_conv.init(jax.random.PRNGKey(8), x)
    want = np.asarray(flax_conv.apply(variables, x))
    kern = np.asarray(variables["params"]["kernel"])
    conv = zoo.Conv(3, 5, kernel, strides)
    spatial = len(kernel)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            kern.transpose((spatial + 1, spatial, *range(spatial))).copy()))
        conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["bias"])))
    got = conv(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_cifar_cnn_bf16_forward_tracks_flax():
    # the engine's bf16 compute: params and inputs cast to bf16, f32 logits
    x = np.random.default_rng(9).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jax_model, model = jax_zoo.CIFARCNN(), zoo.CIFARCNN()
    variables = jax_model.init(jax.random.PRNGKey(10), x, training=False)
    params, _ = variables_from_flax(model, variables)
    bf16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), variables)
    want = np.asarray(jax_model.apply(bf16, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got, _ = TorchModel(model).apply({k: v.bfloat16() for k, v in params.items()}, {},
                                     torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_batch_norm_keeps_f32_statistics_under_bf16():
    # as the engine runs it: bf16 input and scale/bias, f32 running buffers
    bn = zoo.BatchNorm(4)
    x = torch.randn(8, 4, 3, 3, generator=torch.Generator().manual_seed(0)) * 3 + 1
    state = {"running_mean": torch.zeros(4), "running_var": torch.ones(4)}
    params = {"weight": torch.ones(4, dtype=torch.bfloat16),
              "bias": torch.zeros(4, dtype=torch.bfloat16)}
    y = torch.func.functional_call(bn, {**params, **state}, (x.bfloat16(),), {"training": True})
    assert y.dtype == torch.bfloat16 and state["running_var"].dtype == torch.float32
    xf = x.bfloat16().float()
    torch.testing.assert_close(state["running_mean"], 0.1 * xf.mean(dim=(0, 2, 3)),
                               rtol=1e-6, atol=1e-6)
    biased = xf.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(state["running_var"], 0.9 + 0.1 * biased, rtol=1e-5, atol=1e-5)


def test_batch_norm_statistics_are_at_least_f32():
    # as flax promotes them: f64 inputs keep f64 statistics and output
    x = np.random.default_rng(13).normal(loc=2.0, size=(6, 3, 4, 4))
    f64 = dict(dtype=torch.float64)
    state = {"running_mean": torch.zeros(3, **f64), "running_var": torch.ones(3, **f64)}
    params = {"weight": torch.ones(3, **f64), "bias": torch.zeros(3, **f64)}
    y = torch.func.functional_call(zoo.BatchNorm(3), {**params, **state}, (torch.from_numpy(x),),
                                   {"training": True})
    assert y.dtype == torch.float64
    mean, var = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    want = (x - mean[None, :, None, None]) / np.sqrt(var + 1e-5)[None, :, None, None]
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(state["running_var"].numpy(), 0.9 + 0.1 * var, rtol=1e-12)


def test_zoo_models_draw_flax_initialisers():
    g = torch.Generator().manual_seed(0)
    model = zoo.TextCNN(vocab_size=2000, embed_dim=64, filters=64, generator=g)
    std = float(model.embed.weight.detach().std())  # normal, std 1 / sqrt(dim)
    assert abs(std * 64 ** 0.5 - 1.0) < 0.02
    conv = model.convs[0].weight.detach()  # lecun normal: variance 1 / fan_in
    assert abs(float(conv.var()) * 64 * 3 - 1.0) < 0.05
    assert float(conv.abs().max()) <= 2.0 * (64 * 3) ** -0.5 / 0.87962566103423978 + 1e-6
    assert all(float(c.bias.detach().abs().max()) == 0.0 for c in model.convs)
    resnet = zoo.ResNet20(generator=g)
    bn = resnet.stem_bn
    assert float(bn.weight.detach().min()) == 1.0 == float(bn.running_var.min())
    again = zoo.TextCNN(vocab_size=2000, embed_dim=64, filters=64,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.embed.weight, model.embed.weight)
