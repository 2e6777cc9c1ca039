"""The serving engine's step programs on the CPU, against the JAX engine's.

On a card the port runs each of the JAX engine's compiled programs (the
decode step, the speculative iteration, one prefill for each role and bucket
width) as a captured CUDA graph, which may read only fixed storage; on the
CPU they run eagerly.  Here, on the ``TransformerLM(vocab 23, dim 16, heads
2, 2 layers, max_len 32)`` of ``tests/test_torch_serving.py``:

* the prefill, whose slot and prompt length are device data, gives the JAX
  engine's first tokens and K/V pages for two slots and two prompt lengths
  of one bucket;
* across a hot swap the engine's tokens are the JAX engine's across its
  swap (greedy, and a sampled request whose top-k of 1 makes the draw
  exact in both packages), and a sampled request after the swap is a fresh
  engine's over the new weights;
* the decode, speculative and prefill programs run under the transfer
  guard with the sanitizer strict and read nothing on the host: the CPU's
  proxy for "capturable".

The captures themselves are ``tests/test_torch_serving_cuda.py``'s.
"""

import time

import numpy as np
import pytest
import torch

from distkeras_tpu.serving import engine as jax_engine
from distkeras_tpu_torch import sanitizer
from distkeras_tpu_torch.sanitizer import runtime, transfer
from distkeras_tpu_torch.serving import GenerateRequest, ServingEngine
from distkeras_tpu_torch.serving import engine as port_engine
from distkeras_tpu_torch.telemetry.metrics import Registry
from test_torch_serving import CFG, VOCAB, _init

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

GEOMETRY = dict(num_slots=3, page_size=8)
SAMPLED = dict(temperature=0.8, top_k=1, seed=5)  # top-k 1: the draw is the argmax


@pytest.fixture(scope="module")
def lms():
    """The target, the weights it is swapped to, and a one-layer draft."""
    return _init(CFG, 0), _init(CFG, 5), _init(dict(CFG, num_layers=1), 1)


def _admit(engine, module, slot, prompt, **knobs):
    """Prefill ``prompt`` into ``slot`` of an engine whose loop is not
    running (``module``: that engine's package's engine module); returns the
    first token."""
    request = GenerateRequest(prompt=prompt, max_new_tokens=4, **knobs)
    pending = module._Pending(request, 4, time.perf_counter())
    engine._prefill_into(slot, pending, engine._cache.pages_needed(len(prompt) + 4))
    return engine._slots[slot].tokens[0]


def test_prefill_with_device_slot_and_length_matches_jax(lms):
    (jax_model, jax_params, model, params), _, _ = lms
    jax_side = jax_engine.ServingEngine(jax_model, jax_params, registry=Registry(), **GEOMETRY)
    port = ServingEngine(model, params, registry=Registry(), device="cpu", **GEOMETRY)
    assert port.prefill_buckets == (8, 16, 32)
    rng = np.random.default_rng(7)
    # two prompt lengths of the bucket of width 16, into slots 2 and 0
    for slot, n in ((2, 9), (0, 14)):
        prompt = rng.integers(0, VOCAB, n).tolist()
        assert _admit(port, port_engine, slot, prompt) == _admit(jax_side, jax_engine, slot,
                                                                 prompt)
        assert port._dev["at"].tolist() == [slot, n]
    np.testing.assert_array_equal(port._cache.tables, np.asarray(jax_side._cache.tables))
    for name in ("k_pages", "v_pages"):
        np.testing.assert_allclose(getattr(port._cache, name).numpy(),
                                   np.asarray(getattr(jax_side._cache, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_tokens_across_a_hot_swap_match_jax(lms):
    (jax_model, jax_params, model, params), (_, jax_other, other, other_params), _ = lms
    jax_side = jax_engine.ServingEngine(jax_model, jax_params, registry=Registry(), **GEOMETRY)
    port = ServingEngine(model, params, registry=Registry(), device="cpu", **GEOMETRY)
    fresh = ServingEngine(other, other_params, registry=Registry(), device="cpu", **GEOMETRY)
    prompts = ([3, 1, 4, 1, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2])

    def served(engine):
        return [engine.generate(p, max_new_tokens=6, timeout=120, **knobs).tokens
                for p in prompts for knobs in ({}, SAMPLED)]

    try:
        want = served(jax_side)
        jax_side.hot_swap(jax_model, jax_other)
        want_swapped = served(jax_side)
        assert served(port) == want
        port.hot_swap(other, other_params)
        assert served(port) == want_swapped != want  # the swap changed what is served
        knobs = dict(max_new_tokens=8, temperature=0.9, top_k=5, seed=11, timeout=120)
        assert port.generate(prompts[1], **knobs).tokens == \
            fresh.generate(prompts[1], **knobs).tokens
    finally:
        for engine in (jax_side, port, fresh):
            engine.stop()


def test_step_programs_read_nothing_on_the_host(lms):
    (_, _, model, params), _, (_, _, draft, draft_params) = lms
    engines = {
        "plain": ServingEngine(model, params, registry=Registry(), device="cpu", **GEOMETRY),
        "spec": ServingEngine(model, params, registry=Registry(), device="cpu", draft_model=draft,
                              draft_params=draft_params, spec_tokens=3, **GEOMETRY),
    }
    sanitizer.configure("strict")
    try:
        for name, engine in engines.items():
            _admit(engine, port_engine, 0, [1, 2, 3], temperature=0.8, seed=1)
            # the next admission's arrays, uploaded as the loop uploads them
            engine._host["prompt"].numpy()[:4] = (4, 5, 6, 7)
            engine._host["at"].numpy()[:] = (1, 4)
            engine._upload()
            spec, k, v = engine._spec, engine._cache.k_pages, engine._cache.v_pages
            with transfer.guard(f"{name} programs"):
                first = engine._prefill(spec, k, v, 8, sample=True)
                if name == "spec":
                    dc = engine._draft_cache
                    engine._prefill(engine._draft_spec, dc.k_pages, dc.v_pages, 8, sample=False)
                    out, count, accepted = engine._spec_iteration(spec)
                    step = torch.cat([out, count[:, None], accepted[:, None]], dim=1)
                else:
                    step = engine._decode(spec, k, v)
            assert first.shape == (1,) and step.shape[0] == GEOMETRY["num_slots"]
        assert runtime.violations("transfer") == []
    finally:
        sanitizer.configure(None)
        for engine in engines.values():
            engine.stop()
