"""Port parity: the staged models (``models/staged.py``) against the JAX
package's ``StagedTransformer`` and ``StagedLM`` at a small size (vocab 50,
dim 32, 2 heads, max_len 64, 2 stages of 1 or 2 blocks), their flax
parameters carried over with ``params_from_flax`` and the inputs from numpy
seeds; in one process, on the sequential executor.

The sequential forward (and the packed LM's) within 1e-5 of flax; the
port's own init in the flax layout; KV-cache decode within 1e-5 of the
full-context forward; greedy decode, sequential, through ``greedy_generate``
and through the serving engine, token for token the JAX package's
(``greedy_generate_staged`` and its ``ServingEngine`` over the same
``StagedLM``).
"""

import time

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import StagedLM as JaxStagedLM
from distkeras_tpu.models import StagedTransformer as JaxStaged
from distkeras_tpu.models.generate import greedy_generate_staged as jax_greedy_staged
from distkeras_tpu_torch.models import (
    StagedLM,
    StagedTransformer,
    TrainedModel,
    greedy_generate,
    params_from_flax,
    stack_block_params,
)
from distkeras_tpu_torch.models.generate import greedy_generate_staged

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

TOL = 1e-5
VOCAB = 50
BASE = dict(vocab_size=VOCAB, dim=32, heads=2, max_len=64)
LAYOUTS = [(2, 1), (2, 2)]


def _pair(kind, num_stages=2, per_stage=2, seed=0, **extra):
    """``(jax model, flax params, port model, port params)``."""
    cfg = dict(BASE, num_stages=num_stages, blocks_per_stage=per_stage, **extra)
    jax_model, port_model = ((JaxStagedLM(**cfg), StagedLM(**cfg)) if kind == "lm"
                             else (JaxStaged(**cfg), StagedTransformer(**cfg)))
    sample = np.zeros((2, 8, 2) if extra.get("packed") else (2, 8), np.int32)
    params, _ = jax_model.init(jax.random.PRNGKey(seed), sample)
    return jax_model, params, port_model, params_from_flax(port_model, params)


def _tokens(batch, length, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, length), dtype=np.int32)


@pytest.fixture(scope="module")
def lm():
    return _pair("lm")


@pytest.mark.parametrize("kind", ["classifier", "lm"])
@pytest.mark.parametrize("num_stages,per_stage", LAYOUTS)
def test_staged_forward_matches_flax(kind, num_stages, per_stage):
    jax_model, params, model, port = _pair(kind, num_stages, per_stage)
    x = _tokens(3, 16, 1)
    want = np.asarray(jax_model.apply(params, {}, x)[0])
    got = model.apply(port, {}, torch.from_numpy(x))[0].detach().numpy()
    assert got.shape == want.shape == ((3, 16, VOCAB) if kind == "lm" else (3, 2))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_packed_staged_lm_matches_flax():
    """``StagedLM(packed=True)``: per-segment positions and intra-segment
    attention, as the JAX package's sequential executor computes them."""
    jax_model, params, model, port = _pair("lm", packed=True)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, VOCAB, (2, 16)).astype(np.int32)
    segments = np.array([[1] * 5 + [2] * 7 + [3] * 4, [1] * 9 + [2] * 5 + [0] * 2], np.int32)
    x = np.stack([tokens, segments], -1)
    want = np.asarray(jax_model.apply(params, {}, x)[0])
    got = model.apply(port, {}, torch.from_numpy(x))[0].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["classifier", "lm"])
def test_port_init_has_the_flax_layout(kind):
    """The port's own init draws the tree ``params_from_flax`` gives, leaf
    for leaf in shape, blocks stacked ``[S, per_stage, ...]``; LayerNorms at
    identity, biases zero; and ``stack_block_params`` folds per-block dicts
    into that stacking."""
    _, _, model, port = _pair(kind, 2, 2)
    mine, state = model.init(torch.Generator().manual_seed(0), None)
    assert state == {}
    shapes = lambda t: {k: {n: tuple(v.shape) for n, v in sub.items()} for k, sub in t.items()}
    assert shapes(mine) == shapes(port)
    assert mine["blocks"]["fc1.weight"].shape[:2] == (2, 2)
    assert torch.equal(mine["blocks"]["ln1.weight"], torch.ones(2, 2, 32))
    assert not mine["blocks"]["fc1.bias"].any() and not mine["head"]["out.bias"].any()
    per_block = [{n: v.reshape(4, *v.shape[2:])[i] for n, v in port["blocks"].items()}
                 for i in range(4)]
    stacked = stack_block_params(per_block, 2, 2)
    assert all(torch.equal(stacked[n], port["blocks"][n]) for n in stacked)


def test_kv_cache_matches_recompute_staged_lm(lm):
    """Decode chunks through the per-block KV caches give the full-context
    forward's logits (tests/test_generate.py's staged case)."""
    _, _, model, port = lm
    tokens = _tokens(2, 12, 3)
    cache = model.init_cache(2)
    with torch.no_grad():
        full = model.apply(port, {}, torch.from_numpy(tokens))[0]
        chunks = [model.decode_step(port, cache, torch.from_numpy(tokens[:, a:b]), a)[0]
                  for a, b in ((0, 8), (8, 9), (9, 10), (10, 12))]
    assert cache.index == 12
    np.testing.assert_allclose(torch.cat(chunks, 1).numpy(), full.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("steps", [0, 1, 6])
def test_greedy_generate_staged_matches_jax(lm, steps):
    jax_model, params, model, port = lm
    prompt = _tokens(4, 8, 4)
    want = np.asarray(jax_greedy_staged(jax_model, params, prompt, steps))
    got = greedy_generate_staged(model, port, prompt, steps, device="cpu")
    assert got.dtype == np.int32 and got.shape == (4, 8 + steps)
    np.testing.assert_array_equal(got, want)
    trained = TrainedModel(model, port, device="cpu")
    np.testing.assert_array_equal(greedy_generate(trained, prompt, steps), want)


def test_staged_lm_serves_the_jax_engines_tokens(lm):
    """A ``StagedLM`` (a ``TrainedModel``, and raw with its staged
    parameters) resolves through ``decode_spec`` and serves, under staggered
    requests, the JAX package's engine's greedy tokens over the same
    model."""
    from distkeras_tpu.serving import engine as jax_engine
    from distkeras_tpu_torch.serving import GenerateRequest, ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    jax_model, params, model, port = lm
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 7, 12)]
    steps = (6, 9, 5)
    ref = jax_engine.ServingEngine(jax_model, params, num_slots=3, page_size=8, registry=None)
    try:
        want = [ref.generate(p, max_new_tokens=s).tokens for p, s in zip(prompts, steps)]
    finally:
        ref.stop()
    for target, target_params in ((TrainedModel(model, port, device="cpu"), None),
                                  (model, port)):
        engine = ServingEngine(target, target_params, num_slots=3, page_size=8,
                               registry=Registry(), device="cpu")
        try:
            pending = []
            for prompt, n in zip(prompts, steps):
                pending.append(engine.submit(GenerateRequest(prompt=prompt, max_new_tokens=n)))
                time.sleep(0.01)  # later requests join a running batch
            got = [p.result(timeout=120).tokens for p in pending]
        finally:
            engine.stop()
        assert got == want


def test_decode_spec_is_the_transformer_lm_layout(lm):
    _, _, model, port = lm
    spec = model.decode_spec(port)
    assert spec["config"] == dict(dim=32, heads=2, head_dim=16, num_layers=4, max_len=64,
                                  vocab_size=VOCAB, ln_eps=1e-6)
    assert len(spec["blocks"]) == 4 and set(spec["blocks"][0]) == set(port["blocks"])
    assert torch.equal(spec["blocks"][3]["fc2.weight"], port["blocks"]["fc2.weight"][1, 1])
    assert set(spec["final_ln"]) == set(spec["head"]) == {"weight", "bias"}


def test_staged_lm_checks():
    """JAX's ``num_classes`` error, ``ln_eps`` reaching every LayerNorm, and
    the seq axis (item 15c-ii) reaching every block's attention, the
    trainers' twin without it on the same parameter layout."""
    with pytest.raises(ValueError, match="num_classes does not apply"):
        StagedLM(**BASE, num_classes=3)
    model = StagedLM(**BASE, ln_eps=1e-5)
    assert model._block.ln1.eps == model._block.ln2.eps == 1e-5
    assert model.decode_spec(model.init(torch.Generator(), None)[0])["config"]["ln_eps"] == 1e-5
    from distkeras_tpu_torch.trainers import _serving_twin

    ring = StagedTransformer(**BASE, seq_axis="seq")
    assert ring._block.attn.seq_axis == "seq" and ring._block.attn.causal is False
    twin = _serving_twin(ring)
    assert twin.seq_axis is None and twin._block.attn.seq_axis is None
    assert type(twin) is StagedTransformer and twin.num_blocks == ring.num_blocks
    shapes = lambda m: {k: {n: tuple(v.shape) for n, v in sub.items()}
                        for k, sub in m.init(torch.Generator(), None)[0].items()}
    assert shapes(twin) == shapes(ring)
