"""Port parity: KV-cache decode (``TransformerLM(decode=True, cache=...)``)
and ``greedy_generate`` of ``distkeras_tpu_torch`` against the JAX
package's, on a ``TransformerLM(vocab 23, dim 16, heads 2, 2 layers,
max_len 32)`` whose flax parameters are carried over with
``params_from_flax``; prompts from numpy seeds.

Cached greedy decode emits the JAX ``greedy_generate_module``'s tokens
exactly, decode logits are within 1e-5 of the recompute path and of the
JAX decode, writing past ``max_len`` poisons the output with NaN as there,
and the validation and refusals raise by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models.generate import greedy_generate_module as jax_generate
from distkeras_tpu_torch.models import (
    MLP,
    TorchModel,
    TrainedModel,
    TransformerClassifier,
    TransformerLM,
    greedy_generate,
    params_from_flax,
)
from distkeras_tpu_torch.models.generate import greedy_generate_module

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

CFG = dict(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=32)
TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    jax_model = JaxLM(**CFG)
    params = jax_model.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    model = TransformerLM(**CFG)
    return jax_model, params, model, params_from_flax(model, params)


def _prompt(batch, length, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], (batch, length),
                                                dtype=np.int32)


@pytest.mark.parametrize("batch,length,steps", [(3, 7, 12), (2, 8, 24)])
def test_greedy_matches_jax(lm, batch, length, steps):
    jax_model, params, model, port_params = lm
    prompt = _prompt(batch, length, batch)
    ref = jax_generate(jax_model, params, prompt, steps)
    out = greedy_generate_module(model, port_params, prompt, steps, device="cpu")
    assert out.dtype == np.int32 and out.shape == (batch, length + steps)
    np.testing.assert_array_equal(out, ref)


def test_trained_model_entry_matches_module_entry(lm):
    _, _, model, port_params = lm
    prompt = _prompt(2, 5, 7)
    trained = TrainedModel(TorchModel(model), port_params, device="cpu")
    np.testing.assert_array_equal(
        greedy_generate(trained, prompt, 9),
        greedy_generate_module(model, port_params, prompt, 9, device="cpu"))


def test_decode_logits_match_recompute_and_jax(lm):
    jax_model, params, model, port_params = lm
    tokens = _prompt(2, 12, 3)
    cache = model.init_cache(2)
    with torch.no_grad():
        full = torch.func.functional_call(model, port_params, (torch.from_numpy(tokens),))
        chunks = [torch.func.functional_call(
            model, port_params, (torch.from_numpy(tokens[:, a:b]),),
            {"decode": True, "cache": cache}) for a, b in ((0, 8), (8, 9), (9, 10), (10, 12))]
    decoded = torch.cat(chunks, dim=1).numpy()
    assert cache.index == 12
    np.testing.assert_allclose(decoded, full.numpy(), atol=TOL, rtol=TOL)

    ref, variables = jax_model.apply({"params": params}, jnp.asarray(tokens[:, :8]),
                                     decode=True, mutable=["cache"])
    step, _ = jax_model.apply({"params": params, "cache": variables["cache"]},
                              jnp.asarray(tokens[:, 8:9]), decode=True, mutable=["cache"])
    np.testing.assert_allclose(decoded[:, :8], np.asarray(ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(decoded[:, 8:9], np.asarray(step), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(cache.keys[0][:, 12:].numpy(), 0.0)  # unwritten rows


def test_decode_past_max_len_is_nan_as_jax(lm):
    jax_model, params, model, port_params = lm
    tokens = _prompt(1, 32, 4)
    cache = model.init_cache(1)
    _, variables = jax_model.apply({"params": params}, jnp.asarray(tokens), decode=True,
                                   mutable=["cache"])
    ref, _ = jax_model.apply({"params": params, "cache": variables["cache"]},
                             jnp.asarray(tokens[:, :1]), decode=True, mutable=["cache"])
    with torch.no_grad():
        torch.func.functional_call(model, port_params, (torch.from_numpy(tokens),),
                                   {"decode": True, "cache": cache})
        out = torch.func.functional_call(model, port_params, (torch.from_numpy(tokens[:, :1]),),
                                         {"decode": True, "cache": cache})
    assert np.isnan(np.asarray(ref)).all() and torch.isnan(out).all()
    assert cache.index == 33


def test_validation_matches_jax(lm):
    jax_model, params, model, port_params = lm
    prompt = _prompt(2, 8, 5)
    for fn in (lambda *a: jax_generate(jax_model, params, *a),
               lambda *a: greedy_generate_module(model, port_params, *a, device="cpu")):
        with pytest.raises(ValueError, match="max_len"):
            fn(prompt, 25)
        with pytest.raises(ValueError, match="batch"):
            fn(prompt[0], 2)
        with pytest.raises(ValueError, match="steps must be >= 0"):
            fn(prompt, -1)
        np.testing.assert_array_equal(fn(prompt, 0), prompt)


def test_non_lm_models_are_refused_by_name(lm):
    _, _, model, port_params = lm
    prompt = _prompt(1, 4, 6)
    mlp = MLP(features=(8,), num_classes=2, in_features=8)
    trained = TrainedModel(TorchModel(mlp), {k: v.detach() for k, v in mlp.named_parameters()},
                           device="cpu")
    with pytest.raises(TypeError, match="decode"):
        greedy_generate(trained, prompt, 2)
    clf = TransformerClassifier(vocab_size=23, num_classes=2, dim=16, heads=2, num_layers=1,
                                max_len=16)
    trained = TrainedModel(TorchModel(clf), {k: v.detach() for k, v in clf.named_parameters()},
                           device="cpu")
    with pytest.raises(TypeError, match="KV-cache decode"):
        greedy_generate(trained, prompt, 2)
    with pytest.raises(TypeError, match="TrainedModel"):
        greedy_generate(model, prompt, 2)


def test_staged_and_pipelined_decode_are_refused_by_name(lm):
    _, _, model, port_params = lm

    class Staged(TorchModel):
        def decode_step(self, *args):  # what marks a StagedLM
            raise AssertionError("not reached")

    trained = TrainedModel(TorchModel(model), port_params, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        greedy_generate(trained, _prompt(1, 4, 0), 2, pipelined=True)
    with pytest.raises(NotImplementedError, match="item 15"):
        greedy_generate(TrainedModel(Staged(model), port_params, device="cpu"),
                        _prompt(1, 4, 0), 2)


def test_decode_misuse_raises(lm):
    _, _, model, port_params = lm
    tokens = torch.from_numpy(_prompt(1, 4, 1))
    with pytest.raises(ValueError, match="init_cache"):
        model(tokens, decode=True)
    with pytest.raises(ValueError, match="only with decode=True"):
        model(tokens, cache=model.init_cache(1))
    block = model.blocks[0]
    x = torch.zeros(1, 4, CFG["dim"])
    kv = (torch.zeros(1, 32, 2, 8), torch.zeros(1, 32, 2, 8))
    with pytest.raises(ValueError, match="segment_ids"):
        block(x, decode=True, segment_ids=torch.ones(1, 4), kv=kv)
    clf = TransformerClassifier(vocab_size=23, num_classes=2, dim=16, heads=2, num_layers=1)
    with pytest.raises(ValueError, match="causal=True"):
        clf.blocks[0](x, decode=True, kv=kv)


def test_default_device_raises_without_cuda(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is usable")
    _, _, model, port_params = lm
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate_module(model, port_params, _prompt(1, 4, 0), 2)

