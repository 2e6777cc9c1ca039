"""The serving slice's entry points on the card: ``greedy_generate``,
``ServingEngine`` (plain and speculative) and ``ModelPredictor(engine=)``.

On a card the engine runs its step programs (decode, the speculative
iteration, each used prefill) as captured CUDA graphs; a case holds them to
the engine's eager path, ``_use_graphs = False``, bit for bit, across a hot
swap too.  Every test is ``cuda``-marked and skips without a card.  The file imports
no JAX, so it runs where only PyTorch is installed: the models are drawn
from seeded ``torch.Generator``s and held to the same entry points on the
CPU, whose parity with the JAX package the CPU tests pin.  Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py``.
"""

import time

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM, greedy_generate
from distkeras_tpu_torch.serving import GenerateRequest, ServingEngine
from distkeras_tpu_torch.telemetry.metrics import Registry

pytestmark = pytest.mark.cuda

CFG = dict(vocab_size=97, dim=64, heads=4, num_layers=2, max_len=64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _lm(seed, **overrides):
    model = TransformerLM(**dict(CFG, **overrides), generator=torch.Generator().manual_seed(seed))
    return model, {k: v.detach() for k, v in model.named_parameters()}


def _prompts(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=int(k)).tolist()
            for k in rng.integers(3, 20, size=n)]


def test_greedy_generate_on_the_card_matches_the_cpu():
    _card()
    model, params = _lm(0)
    prompt = np.random.default_rng(0).integers(0, CFG["vocab_size"], (3, 9), dtype=np.int32)
    card = greedy_generate(TrainedModel(TorchModel(model), params, device="cuda"), prompt, 20)
    cpu = greedy_generate(TrainedModel(TorchModel(model), params, device="cpu"), prompt, 20)
    np.testing.assert_array_equal(card, cpu)


def test_engine_on_the_card_matches_greedy_generate_and_reruns_samples():
    _card()
    model, params = _lm(1)
    trained = TrainedModel(TorchModel(model), params, device="cuda")
    engine = ServingEngine(trained, num_slots=4, page_size=8, registry=Registry())
    try:
        assert engine._cache.k_pages.is_cuda
        prompts = _prompts(6, 1)
        pendings = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=12)) for p in prompts]
        for p, pending in zip(prompts, pendings):
            ref = greedy_generate(trained, np.asarray([p], np.int32), 12)[0, len(p):]
            assert pending.result(timeout=120).tokens == ref.tolist()
        knobs = dict(max_new_tokens=10, temperature=0.9, top_k=20, top_p=0.95, seed=4,
                     timeout=120)
        alone = engine.generate(prompts[0], **knobs).tokens
        noise = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=8)) for p in prompts[1:3]]
        assert engine.generate(prompts[0], **knobs).tokens == alone
        assert all(p.result(timeout=120) is not None for p in noise)
        deadline = time.monotonic() + 10
        while engine.stats()["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert engine.stats()["pages_in_use"] == 0
    finally:
        engine.stop()
    assert engine.alive


def test_speculative_engine_on_the_card_matches_plain_greedy():
    _card()
    model, params = _lm(2)
    draft, dparams = _lm(3, dim=32, heads=2, num_layers=1)
    trained = TrainedModel(TorchModel(model), params, device="cuda")
    spec = ServingEngine(trained, num_slots=3, page_size=8, registry=Registry(),
                         draft_model=draft, draft_params=dparams, spec_tokens=4)
    faithful = ServingEngine(trained, num_slots=3, page_size=8, registry=(reg := Registry()),
                             draft_model=trained, spec_tokens=4)
    try:
        for p in _prompts(4, 2):
            ref = greedy_generate(trained, np.asarray([p], np.int32), 15)[0, len(p):].tolist()
            assert spec.generate(p, max_new_tokens=15, timeout=120).tokens == ref
            assert faithful.generate(p, max_new_tokens=15, timeout=120).tokens == ref
        snap = reg.snapshot()
        assert snap["serving_spec_accepted_total"]["value"] == \
            snap["serving_spec_proposed_total"]["value"] > 0
        assert snap["serving_decode_steps_total"]["value"] < snap["serving_tokens_total"]["value"]
    finally:
        spec.stop()
        faithful.stop()


def test_model_predictor_through_the_engine_on_the_card():
    _card()
    model, params = _lm(4)
    engine = ServingEngine(TrainedModel(TorchModel(model), params, device="cuda"), num_slots=4,
                           page_size=8, queue_size=3, registry=Registry())
    try:
        prompts = np.random.default_rng(4).integers(0, CFG["vocab_size"], (9, 6), dtype=np.int32)
        predictor = tdk.ModelPredictor(engine=engine, max_new_tokens=7)
        out = predictor.predict(tdk.from_numpy(prompts))["prediction"]
        assert predictor.last_mode == "engine"
        for row, tokens in zip(prompts, out):
            assert list(tokens) == engine.generate(row.tolist(), max_new_tokens=7,
                                                   timeout=120).tokens
    finally:
        engine.stop()


def test_decode_steps_do_not_wait_for_the_card():
    """A decode step (and a speculative iteration's draft and verify
    steps) enqueues its work without one synchronizing call: PyTorch's sync
    debug mode raises on any.  The step's only wait is the token copy the
    loop makes after it."""
    _card()
    from distkeras_tpu_torch.serving.engine import _Pending

    model, params = _lm(5)
    draft, dparams = _lm(6, dim=32, heads=2, num_layers=1)
    for kwargs in ({}, dict(draft_model=draft, draft_params=dparams, spec_tokens=3)):
        engine = ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                               **kwargs)
        for slot, (prompt, temperature) in enumerate((([1, 2, 3], 0.0), ([4, 5], 0.8))):
            request = GenerateRequest(prompt=prompt, max_new_tokens=10,
                                      temperature=temperature, seed=slot)
            engine._prefill_into(slot, _Pending(request, 10, time.perf_counter()),
                                 engine._cache.pages_needed(len(prompt) + 10))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine._upload()
            st = engine._dev
            if kwargs:
                dc = engine._draft_cache
                last, drafts, qprobs = st["last"], [], []
                for i in range(3):
                    last, qp = engine._draft_step(dc.k_pages, dc.v_pages, st["pos"] + i, last, i)
                    drafts.append(last)
                    qprobs.append(qp)
                out = engine._verify(engine._spec, engine._cache.k_pages, engine._cache.v_pages,
                                     torch.stack(drafts, 1), torch.stack(qprobs, 1))[0]
            else:
                out = engine._decode(engine._spec, engine._cache.k_pages, engine._cache.v_pages)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert out.is_cuda and out.shape[0] == 3
        engine.stop()


def test_captured_programs_match_eager_bit_for_bit():
    """Plain and speculative engines serve the same greedy and sampled
    traffic captured and eager, before and after a hot swap to other
    weights: the tokens are equal bit for bit.  Captured: one decode (or
    speculative) graph and one prefill graph for each role and bucket used,
    recaptured after the swap; a replay for every decode step and every
    prefill; eager: no graph."""
    _card()
    model, params = _lm(7)
    other, other_params = _lm(8)
    draft, dparams = _lm(9, dim=32, heads=2, num_layers=1)
    prompts = _prompts(5, 7)
    knobs = [{} if i % 2 == 0 else dict(temperature=0.9, top_k=20, top_p=0.95, seed=i)
             for i in range(len(prompts))]
    buckets = {min(w for w in (8, 16, 32, 64) if w >= len(p)) for p in prompts}

    def serve(engine):
        pendings = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=12, **k))
                    for p, k in zip(prompts, knobs)]
        return [p.result(timeout=120).tokens for p in pendings]

    for kwargs in ({}, dict(draft_model=draft, draft_params=dparams, spec_tokens=3)):
        runs = {}
        for captured in (True, False):
            registry = Registry()
            engine = ServingEngine(model, params, num_slots=3, page_size=8, registry=registry,
                                   **kwargs)
            engine._use_graphs = captured
            try:
                before = serve(engine)
                programs = sorted(engine._programs)
                captures = engine.graph_stats["captures"]
                engine.hot_swap(other, other_params, timeout=120)
                after = serve(engine)
            finally:
                engine.stop()
            steps = registry.snapshot()["serving_decode_steps_total"]["value"]
            runs[captured] = (before, after, programs, captures, dict(engine.graph_stats),
                              sorted(engine._programs), steps)
        assert runs[True][:2] == runs[False][:2]
        assert runs[False][2:6] == ([], 0, {"captures": 0, "replays": 0}, [])
        _, _, programs, captures, stats, programs_after, steps = runs[True]
        roles = ("target", "draft") if kwargs else ("target",)
        want = sorted([("spec",) if kwargs else ("decode",)]
                      + [("prefill", role, w) for role in roles for w in buckets])
        assert programs == programs_after == want
        assert captures == len(want) and stats["captures"] == 2 * len(want)
        assert stats["replays"] == steps + 2 * len(prompts) * len(roles)


def test_step_programs_are_event_timed_within_their_wall_time():
    """Plain and speculative engines on the card: every decode step's
    CUDA-event seconds are positive and no more than the step's host wall
    time, and each request's prefill device seconds no more than its
    prefill's wall time, captured programs and their first captures alike."""
    import types

    _card()
    model, params = _lm(10)
    draft, dparams = _lm(11, dim=32, heads=2, num_layers=1)
    prompts = _prompts(6, 10)
    for kwargs in ({}, dict(draft_model=draft, draft_params=dparams, spec_tokens=3)):
        engine = ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                               **kwargs)
        seen = {"step_device": [], "token_latency": []}
        for key, log in seen.items():
            engine._metrics[key] = types.SimpleNamespace(observe=log.append)
        try:
            pendings = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=9))
                        for p in prompts]
            results = [p.result(timeout=120) for p in pendings]
        finally:
            engine.stop()
        steps = list(zip(seen["step_device"], seen["token_latency"]))
        assert steps and all(0.0 < device <= wall for device, wall in steps), steps
        for r in results:
            assert r.finish_reason == "length" and len(r.tokens) == 9
            assert 0.0 < r.device_s - r.decode_device_s <= r.prefill_s
            assert 0.0 < r.decode_device_s
            assert abs(r.queue_wait_s + r.prefill_s - r.ttft_s) < 1e-6
