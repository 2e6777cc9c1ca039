"""Port parity: the serving slice of ``distkeras_tpu_torch`` (paged KV cache,
continuous-batching engine, speculative decoding) against the JAX package's,
on a ``TransformerLM(vocab 23, dim 16, heads 2, 2 layers, max_len 32)``
whose flax parameters are carried over with ``params_from_flax``.

* the cache's row scatters and its alloc/free bookkeeping are bit for bit
  JAX's, and the prefill bucket ladder is JAX's;
* staggered continuous batching emits exactly the JAX
  ``greedy_generate_module``'s tokens, speculative greedy exactly plain
  greedy's (a shallow draft, and the target as its own draft, which
  accepts everything);
* slots and pages retire and are reused, EOS retires early, a full queue
  sheds load, unservable requests are refused by message, page churn
  never leaks;
* the decode step keeps its input shapes and the pools their storage
  across staggered traffic (the reference's one-compiled-step pin);
* the SLO metrics render byte for byte as ``tests/golden/serving_metrics.txt``,
  beside the port's own two histograms (queue wait, a step's device
  seconds);
* each result carries its queue wait, prefill and device seconds, which
  sum to its time to first token and to the ledger's device seconds; a
  profiler recording all threads holds the loop's spans, and with
  telemetry and the profiler off no span site opens anything;
* seeded sampling is deterministic and independent of co-batched traffic
  (ROADMAP C9), a crashed loop aborts its requests, and the unported
  options raise naming their ROADMAP items.

The engines are shared per module (their threads run until the module's
teardown) to keep the suite light.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models.generate import greedy_generate_module as jax_generate
from distkeras_tpu.serving import cache as jax_cache
from distkeras_tpu.serving import engine as jax_engine
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import TorchModel, TrainedModel, TransformerLM, params_from_flax
from distkeras_tpu_torch.serving import (
    EngineCrashed,
    GenerateRequest,
    PagedKVCache,
    QueueFull,
    ServingEngine,
    append_rows,
    install_http_endpoint,
    rollback_rows,
    serving_metrics,
)
from distkeras_tpu_torch.models.transformer import masked_attention
from distkeras_tpu_torch.serving.engine import (
    _block_apply,
    _head_apply,
    _resolve_buckets,
    _resolve_spec,
)
from distkeras_tpu_torch.telemetry.metrics import Registry

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

VOCAB = 23
CFG = dict(vocab_size=VOCAB, dim=16, heads=2, num_layers=2, max_len=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _init(cfg, seed):
    jax_model = JaxLM(**cfg)
    params = jax_model.init(jax.random.PRNGKey(seed), np.zeros((1, 4), np.int32))["params"]
    model = TransformerLM(**cfg)
    return jax_model, params, model, params_from_flax(model, params)


@pytest.fixture(scope="module")
def lm():
    return _init(CFG, 0)


@pytest.fixture(scope="module")
def draft_lm():
    """The shallow draft: same vocab, dim and max_len, one layer."""
    return _init(dict(CFG, num_layers=1), 1)


@pytest.fixture(scope="module")
def engines(lm, draft_lm):
    """The plain engine, a speculative one with the shallow (often wrong)
    draft, and one whose draft is the target (accepts everything), each
    with its own registry."""
    _, _, model, params = lm
    _, _, dmodel, dparams = draft_lm
    built = {
        "plain": ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                               device="cpu"),
        "spec": ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                              draft_model=dmodel, draft_params=dparams, spec_tokens=3,
                              device="cpu"),
        "faithful": ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                                  draft_model=model, draft_params=params, spec_tokens=3,
                                  device="cpu"),
    }
    yield built
    for engine in built.values():
        engine.stop()


@pytest.fixture
def make_engine(lm):
    engines = []

    def factory(**kw):
        kw.setdefault("registry", Registry())
        kw.setdefault("device", "cpu")
        engine = ServingEngine(lm[2], lm[3], **kw)
        engines.append(engine)
        return engine

    yield factory
    for engine in engines:
        engine.stop()


def _ref(lm, prompt, steps):
    """The JAX package's lockstep greedy continuation of one prompt."""
    jax_model, params = lm[:2]
    out = jax_generate(jax_model, params, np.asarray([prompt], np.int32), steps)
    return out[0, len(prompt):].tolist()


def _staggered(engine, prompts, steps, **knobs):
    pendings = []
    for prompt, s in zip(prompts, steps):
        pendings.append(engine.submit(GenerateRequest(prompt=prompt, max_new_tokens=s, **knobs)))
        time.sleep(0.01)  # later requests join a running batch
    return [p.result(timeout=120) for p in pendings]


def _settled(engine):
    deadline = time.monotonic() + 10
    while engine.stats()["active_slots"] and time.monotonic() < deadline:
        time.sleep(0.01)
    return engine.stats()


# ------------------------------------------------------------- paged cache


def test_paged_cache_bookkeeping_matches_jax():
    kw = dict(num_layers=2, num_slots=3, page_size=4, pages_per_slot=3, heads=2, head_dim=4)
    port, ref = PagedKVCache(**kw, device="cpu"), jax_cache.PagedKVCache(**kw)
    ops = [("alloc", 0, 2), ("alloc", 1, 3), ("free", 0, None), ("alloc", 2, 1),
           ("alloc", 0, 3), ("free", 1, None), ("alloc", 1, 1), ("free", 2, None)]
    for op, slot, n in ops:
        if op == "alloc":
            port.alloc(slot, n)
            ref.alloc(slot, n)
        else:
            assert port.free(slot) == ref.free(slot)
        np.testing.assert_array_equal(port.tables, ref.tables)
        assert port.pages_in_use == ref.pages_in_use and port._free == ref._free
    assert tuple(port.k_pages.shape) == ref.k_pages.shape and not port.k_pages.any()
    assert port.pages_needed(5) == ref.pages_needed(5) == 2
    assert port.max_context() == ref.max_context() == 12
    for cache in (port, ref):
        with pytest.raises(ValueError, match="table size"):
            cache.alloc(0, 1)
    small = dict(kw, num_pages=3)
    for cache in (PagedKVCache(**small, device="cpu"), jax_cache.PagedKVCache(**small)):
        with pytest.raises(ValueError, match="dry"):
            cache.alloc(0, 3)


@pytest.mark.parametrize("m", [1, 3])
def test_append_and_rollback_rows_match_jax(m):
    rng = np.random.default_rng(m)
    cache = PagedKVCache(num_layers=2, num_slots=3, page_size=4, pages_per_slot=2, heads=2,
                         head_dim=3, device="cpu")
    for slot in range(3):
        cache.alloc(slot, 2 if slot != 1 else 1)
    tables = cache.tables.copy()
    pool = rng.normal(size=tuple(cache.k_pages.shape)).astype(np.float32)
    rows = rng.normal(size=(3, m, 2, 3)).astype(np.float32)
    # slot 2's window ends at its capacity (8): with m = 3 it overhangs by one
    pos = np.array([3, 1, 8 - m + (m > 1)], np.int32)
    count = np.array([1, m, 0], np.int32)
    for layer in (0, 1):
        ref = jax_cache.append_rows(jnp.asarray(pool), layer, jnp.asarray(tables),
                                    jnp.asarray(pos), jnp.asarray(rows))
        out = append_rows(torch.from_numpy(pool.copy()), layer, torch.from_numpy(tables),
                          torch.from_numpy(pos), torch.from_numpy(rows))
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        ref = jax_cache.rollback_rows(ref, layer, jnp.asarray(tables), jnp.asarray(pos),
                                      jnp.asarray(count), m)
        out = rollback_rows(out, layer, torch.from_numpy(tables), torch.from_numpy(pos),
                            torch.from_numpy(count), m)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("buckets", [None, [8], [16, 8], [32]])
def test_bucket_ladder_matches_jax(buckets):
    assert _resolve_buckets(buckets, 8, 32) == jax_engine._resolve_buckets(buckets, 8, 32)
    for bad in ([12], [64], []):
        with pytest.raises(ValueError):
            jax_engine._resolve_buckets(bad, 8, 32)
        with pytest.raises(ValueError):
            _resolve_buckets(bad, 8, 32)


# ----------------------------------------------------- greedy token identity


def test_block_apply_is_the_module_block(lm):
    """The engine's restated block and head math equal the module's own
    forward (flash attention's plain version, causal) on the same
    parameters, so a change to the block cannot drift from serving."""
    _, _, model, params = lm
    spec = _resolve_spec(model, params, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 11, CFG["dim"]))
                         .astype(np.float32))
    hidden = torch.ones(11, 11, dtype=torch.bool).triu(1)[None, :, None, :]
    with torch.no_grad():
        for i, bp in enumerate(spec.blocks):
            ours = _block_apply(bp, x, lambda q, k, v: masked_attention(q, k, v, hidden),
                                spec.ln_eps, spec.heads, spec.head_dim)
            theirs = torch.func.functional_call(model.blocks[i], bp, (x,))
            torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)
        ours = _head_apply(spec.final_ln, spec.head, x, spec.ln_eps)
        theirs = model.lm_head(model.final_ln(x))
        torch.testing.assert_close(ours, theirs, rtol=0, atol=1e-6)


def test_pools_take_the_served_dtype(lm):
    """The KV pools are built in ``dtype=``: an f64 engine (f64 parameters,
    f64 pools) serves the JAX package's greedy tokens."""
    params = {k: v.double() for k, v in lm[3].items()}
    engine = ServingEngine(lm[2], params, num_slots=2, page_size=8, registry=Registry(),
                           dtype=torch.float64, device="cpu")
    try:
        assert engine._cache.k_pages.dtype == engine._cache.v_pages.dtype == torch.float64
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (4, 9)]
        results = _staggered(engine, prompts, (6, 5))
        assert [r.tokens for r in results] == [_ref(lm, p, s) for p, s in zip(prompts, (6, 5))]
    finally:
        engine.stop()


def test_bf16_pools_serve_f32_parameters_as_the_jax_engine(lm):
    """bf16 KV pools under f32 parameters (half the cache): the greedy
    tokens, target and speculative, equal the JAX engine's at
    ``dtype=jnp.bfloat16`` on the same parameters and prompts."""
    jax_model, jparams, model, params = lm
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 7, 12)]
    steps = (6, 9, 5)
    ref = jax_engine.ServingEngine(jax_model, jparams, num_slots=3, page_size=8,
                                   registry=None, dtype=jnp.bfloat16)
    try:
        want = [ref.generate(p, max_new_tokens=s).tokens for p, s in zip(prompts, steps)]
    finally:
        ref.stop()
    for draft in (None, model):
        engine = ServingEngine(model, params, num_slots=3, page_size=8, registry=Registry(),
                               dtype=torch.bfloat16, draft_model=draft,
                               draft_params=None if draft is None else params,
                               spec_tokens=2, device="cpu")
        try:
            pools = [engine._cache] + ([engine._draft_cache] if draft is not None else [])
            assert all(c.k_pages.dtype == c.v_pages.dtype == torch.bfloat16 for c in pools)
            assert all(v.dtype == torch.float32 for v in params.values())
            got = [r.tokens for r in _staggered(engine, prompts, steps)]
        finally:
            engine.stop()
        assert got == want, f"draft={draft is not None}"


def test_engine_signature_follows_jax_in_order():
    """``ServingEngine.__init__`` takes the JAX engine's parameters, in its
    order and with its defaults (``dtype`` f32), then the port's
    ``device``."""
    import inspect

    ours = list(inspect.signature(ServingEngine.__init__).parameters.values())
    theirs = list(inspect.signature(jax_engine.ServingEngine.__init__).parameters.values())
    assert [p.name for p in ours] == [p.name for p in theirs] + ["device"]
    for mine, ref in zip(ours, theirs):
        default = ref.default
        if ref.name == "dtype":
            assert default == jnp.float32 and mine.default == torch.float32
            continue
        assert (mine.kind, mine.default) == (ref.kind, default), ref.name
    assert ours[-1].default == "cuda"


def test_staggered_greedy_matches_jax(lm, engines):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 7, 5, 12)]
    steps = (8, 6, 10, 5)
    refs = [_ref(lm, p, s) for p, s in zip(prompts, steps)]
    for result, ref, prompt in zip(_staggered(engines["plain"], prompts, steps), refs, prompts):
        assert result.finish_reason == "length" and result.tokens == ref
        assert result.prompt == prompt
        assert result.ttft_s > 0 and result.latency_s >= result.ttft_s


def test_speculative_greedy_matches_plain_greedy(lm, engines):
    """Greedy speculative tokens are plain greedy's under staggered arrival
    — the shallow draft (often wrong) only changes when they are emitted."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 7, 5)]
    steps = (8, 6, 10)
    refs = [_ref(lm, p, s) for p, s in zip(prompts, steps)]
    assert [r.tokens for r in _staggered(engines["spec"], prompts, steps)] == refs
    assert [r.tokens for r in _staggered(engines["plain"], prompts, steps)] == refs


def test_faithful_draft_accepts_all_and_steps_per_token_below_one(lm, engines):
    engine = engines["faithful"]

    def counters():
        m = engine._metrics
        return {k: m[k].value for k in ("decode_steps", "tokens", "spec_proposed",
                                        "spec_accepted")}

    before = counters()
    result = engine.generate([1, 2, 3], max_new_tokens=13, timeout=120)
    assert result.tokens == _ref(lm, [1, 2, 3], 13)
    delta = {k: v - before[k] for k, v in counters().items()}
    assert delta["tokens"] == 13
    # the first token is the prefill's: 12 came from decode steps, which a
    # draft that is never right would take one at a time
    assert delta["decode_steps"] / 12 < 1, delta
    assert delta["spec_proposed"] > 0 and delta["spec_accepted"] == delta["spec_proposed"]


def test_slot_retirement_and_reuse(lm, engines):
    """More requests than slots: every slot retires and is admitted into
    again, and every KV page comes back to the pool."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 5, 3, 5, 3, 5)]
    refs = [_ref(lm, p, 5) for p in prompts]
    engine = engines["plain"]
    pendings = [engine.submit(GenerateRequest(prompt=p, max_new_tokens=5)) for p in prompts]
    assert [p.result(timeout=120).tokens for p in pendings] == refs
    stats = _settled(engine)
    assert stats["active_slots"] == 0 and stats["pages_in_use"] == 0


def test_eos_retires_early(lm, engines):
    prompt = [2, 7, 1, 8, 4]
    ref = _ref(lm, prompt, 10)
    eos = ref[3]
    k = ref.index(eos)
    for name in ("plain", "spec"):
        result = engines[name].generate(prompt, max_new_tokens=10, eos_id=eos, timeout=120)
        assert result.finish_reason == "eos" and result.tokens == ref[:k + 1]


# ------------------------------------------------------------------ sampling


def test_seeded_sampling_deterministic_and_traffic_independent(engines):
    """ROADMAP C9: the same seed gives the same tokens, another seed others,
    and co-batched traffic changes nothing (each request's stream advances
    only on its own iterations)."""
    engine = engines["plain"]
    knobs = dict(max_new_tokens=8, temperature=0.9, top_k=7, top_p=0.95, seed=123,
                 timeout=120)
    alone = engine.generate([5, 9, 2], **knobs)
    assert engine.generate([5, 9, 2], **knobs).tokens == alone.tokens
    assert engine.generate([5, 9, 2], **{**knobs, "seed": 7}).tokens != alone.tokens
    rng = np.random.default_rng(4)
    noise = [engine.submit(GenerateRequest(prompt=rng.integers(0, VOCAB, size=6).tolist(),
                                           max_new_tokens=10, temperature=0.5, seed=i))
             for i in range(2)]
    assert engine.generate([5, 9, 2], **knobs).tokens == alone.tokens
    assert all(p.result(timeout=120) is not None for p in noise)


def test_speculative_sampling_deterministic_and_opt_out_is_plain(engines):
    knobs = dict(max_new_tokens=9, temperature=0.9, top_k=7, top_p=0.95, seed=123)
    spec = engines["spec"]
    solo = spec.generate([2, 3, 4], timeout=120, **knobs)
    rng = np.random.default_rng(6)
    others = [
        spec.submit(GenerateRequest(prompt=rng.integers(0, VOCAB, size=5).tolist(),
                                    max_new_tokens=8, temperature=0.7, seed=9)),
        spec.submit(GenerateRequest(prompt=rng.integers(0, VOCAB, size=4).tolist(),
                                    max_new_tokens=8, temperature=0.7, seed=10,
                                    speculative=False)),
    ]
    assert spec.generate([2, 3, 4], timeout=120, **knobs).tokens == solo.tokens
    assert all(p.result(timeout=120) is not None for p in others)
    baseline = engines["plain"].generate([2, 3, 4], timeout=120, **knobs)
    optout = spec.generate([2, 3, 4], timeout=120, speculative=False, **knobs)
    assert optout.tokens == baseline.tokens


# ------------------------------------------------- admission and rejection


def test_queue_backpressure_rejects_and_counts(make_engine):
    registry = Registry()
    engine = make_engine(queue_size=2, registry=registry)
    engine.start = lambda: None  # hold the loop: the queue cannot drain
    held = [engine.submit(GenerateRequest(prompt=[1, 2], max_new_tokens=2)) for _ in range(2)]
    with pytest.raises(QueueFull):
        engine.submit(GenerateRequest(prompt=[1, 2], max_new_tokens=2))
    snap = registry.snapshot()
    assert snap["serving_requests_rejected_total"]["value"] == 1.0
    assert snap["serving_queue_depth"]["value"] == 2.0
    del engine.start
    engine.start()
    assert all(p.result(timeout=120).finish_reason == "length" for p in held)


def test_unservable_requests_rejected_loudly(engines):
    engine = engines["plain"]  # width == max_len == 32
    with pytest.raises(ValueError, match="prompt length"):
        engine.submit(GenerateRequest(prompt=list(range(32))))
    with pytest.raises(ValueError, match="vocabulary"):
        engine.submit(GenerateRequest(prompt=[VOCAB + 5]))
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit(GenerateRequest(prompt=[]))
    with pytest.raises(ValueError, match="draft_model"):
        engine.submit(GenerateRequest(prompt=[1, 2], speculative=True))
    with pytest.raises(ValueError, match="top_p"):
        engine.submit(GenerateRequest(prompt=[1, 2], top_p=1.5))


def test_prefill_buckets_and_padding_counter(lm, engines, make_engine):
    engine = engines["plain"]
    assert engine.prefill_buckets == (8, 16, 32)
    single_reg = Registry()
    single = make_engine(num_slots=2, page_size=8, registry=single_reg, prefill_buckets=[32])
    prompts = [[1, 2, 3], list(range(1, 6)), list(range(1, 11))]
    before = engine._metrics["prefill_padded"].value
    for p in prompts:
        a = engine.generate(p, max_new_tokens=4, timeout=120)
        b = single.generate(p, max_new_tokens=4, timeout=120)
        assert a.tokens == b.tokens  # padding is FLOPs, never values
    assert engine._metrics["prefill_padded"].value - before == sum(
        w - len(p) for w, p in zip((8, 8, 16), prompts))
    assert single_reg.snapshot()["serving_prefill_padded_tokens"]["value"] == sum(
        32 - len(p) for p in prompts)
    with pytest.raises(ValueError, match="multiple"):
        make_engine(prefill_buckets=[12])


def test_paged_cache_churn_never_leaks(lm, engines):
    """Alloc/free churn across interleaved admissions on the speculative
    engine (its append/rollback paths): afterwards the free list is whole,
    tables are all scratch, and a request needing a slot's every page still
    fits and decodes right."""
    engine = engines["faithful"]
    cache = engine._cache
    total_free = cache.pages_free
    rng = np.random.default_rng(12)
    for round_ix in range(3):
        pendings = [engine.submit(GenerateRequest(
            prompt=rng.integers(0, VOCAB, size=int(n)).tolist(),
            max_new_tokens=int(rng.integers(1, 8)), seed=round_ix * 10 + i,
            temperature=0.8 if i % 3 == 0 else 0.0, speculative=bool(i % 2 == 0)))
            for i, n in enumerate(rng.integers(2, 14, size=5))]
        assert all(p.result(timeout=120) is not None for p in pendings)
    _settled(engine)
    assert cache.pages_free == total_free, "page leak under churn"
    assert (cache.tables == 0).all()
    long_prompt = [i % VOCAB for i in range(25)]
    assert engine.generate(long_prompt, max_new_tokens=6, timeout=120).tokens == _ref(
        lm, long_prompt, 6)
    assert cache.pages_free == total_free


def test_decode_step_keeps_shapes_and_pool_storage(engines):
    """The port's counterpart of the reference's one-compiled-step pin:
    after warm-up, admitting, sampling and retiring requests changes no
    shape of the decode step's inputs, allocates no new pool, and the pools
    and slot arrays keep their storage (updated in place)."""
    engine = engines["plain"]
    engine.generate([1, 2, 3], max_new_tokens=3, timeout=120)
    seen = []
    decode = engine._decode

    def recording(spec, kpool, vpool):
        seen.append((kpool.data_ptr(), vpool.data_ptr(), tuple(kpool.shape),
                     tuple((k, tuple(t.shape), t.data_ptr()) for k, t in engine._dev.items())))
        return decode(spec, kpool, vpool)

    engine._decode = recording
    try:
        rng = np.random.default_rng(4)
        pendings = []
        for i, n in enumerate((2, 8, 5, 11, 3)):
            pendings.append(engine.submit(GenerateRequest(
                prompt=rng.integers(0, VOCAB, size=n).tolist(), max_new_tokens=4 + i,
                temperature=0.0 if i % 2 else 0.8, top_k=5 if i == 2 else 0,
                top_p=0.9 if i == 3 else 1.0, seed=i, eos_id=(1 if i == 4 else None))))
            time.sleep(0.01)
        assert all(p.result(timeout=120) is not None for p in pendings)
    finally:
        del engine._decode
    assert len(seen) >= 5 and len(set(seen)) == 1
    assert seen[0][0] == engine._cache.k_pages.data_ptr()


# ------------------------------------------------------------------ metrics


def test_serving_metrics_schema_golden():
    registry = Registry()
    m = serving_metrics(registry)
    m["ttft"].observe(0.004)
    m["ttft"].observe(0.12)
    for _ in range(3):
        m["token_latency"].observe(0.0008)
    m["queue_depth"].set(2)
    m["active_slots"].set(3)
    m["pages_in_use"].set(12)
    m["tokens"].inc(42)
    m["requests"].inc(5)
    m["rejected"].inc(1)
    m["prefill_seconds"].observe(0.006)
    m["prefill_padded"].inc(13)
    m["decode_steps"].inc(17)
    m["spec_proposed"].inc(24)
    m["spec_accepted"].inc(19)
    m["hot_swaps"].inc(2)
    m["queue_wait"].observe(0.003)
    m["step_device"].observe(0.0007)
    with open(os.path.join(GOLDEN, "serving_metrics.txt")) as fh:
        golden = fh.read()
    blocks = _metric_blocks(registry.to_prometheus(labels={"run_id": "fleet1234"}))
    # the JAX package's instruments byte for byte; the port's own beside them
    assert "".join(b for name, b in blocks if name not in PORT_HISTOGRAMS) == golden
    own = {name: b for name, b in blocks if name in PORT_HISTOGRAMS}
    assert set(own) == set(PORT_HISTOGRAMS)
    for name, (help_text, total) in PORT_HISTOGRAMS.items():
        assert own[name].startswith(f"# HELP {name} {help_text}\n# TYPE {name} histogram\n")
        assert f'{name}_sum{{run_id="fleet1234"}} {total}\n' in own[name]
        assert f'{name}_count{{run_id="fleet1234"}} 1\n' in own[name]
    assert serving_metrics(registry)["tokens"] is m["tokens"]


#: the port's serving histograms the JAX package lacks: help and the sum above
PORT_HISTOGRAMS = {
    "serving_queue_wait_seconds": (
        "time from admission-queue entry to the start of the request's prefill", "0.003"),
    "serving_step_device_seconds": (
        "device seconds of one decode step (CUDA events on a card; the step program's "
        "wall time on the CPU)", "0.0007"),
}


def _metric_blocks(text):
    """Prometheus text as ``(name, lines)`` blocks, one an instrument."""
    blocks = []
    for line in text.splitlines(keepends=True):
        if line.startswith("# HELP "):
            blocks.append([line.split()[2], line])
        else:
            blocks[-1][1] += line
    return [tuple(b) for b in blocks]


def test_spans_and_global_registry(make_engine):
    telemetry.configure(True)
    telemetry.trace.reset()
    try:
        engine = make_engine(registry=None)  # the process-global registry
        before = telemetry.metrics.counter("serving_requests_total").value
        engine.generate([1, 2, 3], max_new_tokens=3, timeout=120)
        names = {e["name"] for e in telemetry.trace.events()}
    finally:
        telemetry.configure(None)
    assert {"serving.admit", "serving.queue_wait", "serving.prefill",
            "serving.decode_step"} <= names
    assert telemetry.metrics.counter("serving_requests_total").value == before + 1


@pytest.mark.parametrize("kind", ["plain", "spec"])
def test_result_timings_split_the_time_to_first_token(engines, kind):
    """Every request of a staggered batch: its queue wait and its prefill
    add up to its time to first token (within 1 us), its device seconds
    are its prefill's plus its decode steps' shares, and a request that
    decoded past its first token holds a decode share."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 9, 5, 12, 4)]
    steps = [6, 2, 7, 1, 5]
    results = _staggered(engines[kind], prompts, steps)
    for result, n in zip(results, steps):
        assert result.finish_reason == "length" and len(result.tokens) == n
        assert result.queue_wait_s >= 0.0 and result.prefill_s > 0.0
        assert abs(result.queue_wait_s + result.prefill_s - result.ttft_s) < 1e-6
        assert 0.0 <= result.decode_device_s < result.device_s
        assert (result.decode_device_s > 0.0) == (n > 1)


def test_result_json_round_trips_with_and_without_the_timings():
    from distkeras_tpu_torch.serving.frontend import GenerateResult

    full = GenerateResult(request_id="r", prompt=[1], tokens=[2, 3], finish_reason="length",
                          ttft_s=0.5, latency_s=1.0, trace_id="t", queue_wait_s=0.2,
                          prefill_s=0.3, device_s=0.04, decode_device_s=0.01)
    payload = json.loads(full.to_json())
    assert GenerateResult(**payload) == full
    # a replica that sends no timings (an older one) still reads, at 0.0
    for key in ("queue_wait_s", "prefill_s", "device_s", "decode_device_s"):
        del payload[key]
    old = GenerateResult(**payload)
    assert (old.queue_wait_s, old.prefill_s, old.device_s, old.decode_device_s) == (0.0,) * 4
    assert (old.ttft_s, old.tokens) == (0.5, [2, 3])


def test_a_profiler_of_all_threads_holds_the_loop_spans(make_engine, tmp_path):
    """A capture by the port's own profiler, started after the engine's
    loop thread, with telemetry off: the loop's ``serving.*`` spans are
    annotations of that thread, on the trace's clock."""
    from distkeras_tpu_torch.telemetry.profiler import profile

    engine = make_engine(num_slots=2)
    telemetry.configure(False)
    try:
        engine.generate([1, 2, 3], max_new_tokens=2, timeout=120)  # the loop runs
        loop = engine._thread.native_id
        with profile(str(tmp_path)) as out:
            engine.generate([4, 5, 6, 7], max_new_tokens=4, timeout=120)
            time.sleep(0.1)  # an idle wait of the loop
    finally:
        telemetry.configure(None)
    events = json.load(open(out["path"]))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("serving.")]
    tids = {}
    for e in spans:
        tids.setdefault(e["name"], set()).add(e["tid"])
    # (the module's other engines idle on threads of their own)
    for name in ("serving.prefill", "serving.decode_step", "serving.emit"):
        assert tids[name] == {loop}
    assert loop in tids["serving.idle"]
    assert tids["serving.admit"] == {threading.get_native_id()}
    steps = [e for e in spans if e["name"] == "serving.decode_step"]
    assert len(steps) == 3  # the first token is the prefill's
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == loop]
    step = steps[0]
    # the step's own ops lie inside its span on the one clock
    assert any(step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
               for e in ops)


def test_span_sites_open_nothing_with_telemetry_and_profiler_off(make_engine, monkeypatch):
    """With telemetry off and no profiler recording, serving traffic
    builds no span and opens no ``record_function``; the same traffic
    under a profiler opens one for each loop span."""
    import importlib

    from distkeras_tpu_torch.serving import engine as engine_mod

    trace_mod = importlib.import_module("distkeras_tpu_torch.telemetry.trace")
    opened, built = [], []
    real_rf, real_span = torch.autograd.profiler.record_function, trace_mod.Span

    class CountedAnnotation(real_rf):
        def __init__(self, name, *args, **kwargs):
            opened.append(name)
            super().__init__(name, *args, **kwargs)

    class CountedSpan(real_span):
        __slots__ = ()

        def __init__(self, *args):
            built.append(args[1])
            super().__init__(*args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", CountedAnnotation)
    monkeypatch.setattr(trace_mod, "Span", CountedSpan)
    engine = make_engine(num_slots=2)
    telemetry.configure(False)
    try:
        assert not telemetry.trace.active()
        assert engine._step_span() is engine_mod._span("serving.emit") is engine_mod.NOOP_SPAN
        engine.generate([1, 2, 3], max_new_tokens=3, timeout=120)
        time.sleep(0.1)  # idle waits of the loop
        assert opened == [] and built == []
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        prof.start()
        try:
            engine.generate([1, 2, 3], max_new_tokens=3, timeout=120)
        finally:
            prof.stop()
    finally:
        telemetry.configure(None)
    assert {"serving.admit", "serving.prefill", "serving.decode_step",
            "serving.emit"} <= set(opened)
    assert built == []  # annotations alone: the tracer records nothing


# ------------------------------------------------------- lifecycle and faults


def test_stop_aborts_in_flight_and_queued(make_engine):
    engine = make_engine(num_slots=1, queue_size=8)
    pendings = [engine.submit(GenerateRequest(prompt=[1, 2, 3], max_new_tokens=20))
                for _ in range(3)]
    engine.stop()
    results = [p.result(timeout=10) for p in pendings]
    assert all(r is not None for r in results)
    assert any(r.finish_reason == "aborted" for r in results)
    assert all(r.finish_reason in ("aborted", "length", "eos") for r in results)


def test_crashed_loop_aborts_and_refuses(make_engine):
    engine = make_engine(num_slots=2)

    def broken(*args):
        raise RuntimeError("device step failed")

    engine._decode = broken
    pendings = [engine.submit(GenerateRequest(prompt=[1, 2, 3], max_new_tokens=5))
                for _ in range(3)]
    results = [p.result(timeout=60) for p in pendings]
    assert all(r.finish_reason == "aborted" for r in results)
    assert not engine.alive and "device step failed" in str(engine.error)
    with pytest.raises(EngineCrashed, match="device step failed"):
        engine.submit(GenerateRequest(prompt=[1, 2]))


def test_hot_swap_drain_and_resume(lm, make_engine):
    engine = make_engine(num_slots=2)
    prompt = [3, 1, 4, 1, 5]
    before = engine.generate(prompt, max_new_tokens=6, timeout=120).tokens
    assert before == _ref(lm, prompt, 6)
    other = _init(CFG, 5)
    engine.hot_swap(TrainedModel(TorchModel(other[2]), other[3], device="cpu"), timeout=120)
    assert engine.generate(prompt, max_new_tokens=6, timeout=120).tokens == _ref(other, prompt, 6)
    with pytest.raises(ValueError, match="geometry"):
        wide = TransformerLM(**dict(CFG, dim=32))
        engine.hot_swap(wide, {k: v.detach() for k, v in wide.named_parameters()})
    assert engine.drain(timeout=30)
    queued = engine.submit(GenerateRequest(prompt=prompt, max_new_tokens=2))
    time.sleep(0.1)
    assert not queued.done()  # admission paused: the request stays queued
    engine.resume()
    assert queued.result(timeout=120).finish_reason == "length"


def test_cancel_releases_the_slot(make_engine):
    engine = make_engine(num_slots=1)
    running = engine.submit(GenerateRequest(prompt=[1, 2], max_new_tokens=25))
    queued = engine.submit(GenerateRequest(prompt=[3, 4], max_new_tokens=2))
    assert engine.cancel(queued) and queued.result(timeout=10).finish_reason == "aborted"
    assert engine.cancel(running)
    assert running.result(timeout=60).finish_reason in ("aborted", "length")
    assert _settled(engine)["pages_in_use"] == 0


# ------------------------------------------------------------------ refusals


class _ModelAxis:
    """A 1-D model-axis mesh of ``size`` ranks, as far as the engine's
    checks read one before it joins any group."""

    mesh_dim_names = ("model",)

    def __init__(self, size):
        self._size = size

    def size(self, mesh_dim=None):
        return self._size


def test_unported_options_raise_naming_their_items(lm, tmp_path):
    _, _, model, params = lm
    with pytest.raises(ValueError, match="heads 2 not divisible by mesh size 3"):
        ServingEngine(model, params, mesh=_ModelAxis(3), device="cpu")

    # a StagedLM serves since the pipeline slice (ROADMAP Queue A item 15c):
    # through its decode_spec, the greedy tokens of its own decode
    from distkeras_tpu_torch.models import StagedLM, greedy_generate

    staged = StagedLM(vocab_size=VOCAB, dim=16, heads=2, num_stages=2, max_len=32)
    trained = TrainedModel(staged, staged.init(torch.Generator().manual_seed(0), None)[0],
                           device="cpu")
    engine = ServingEngine(trained, num_slots=2, page_size=8, registry=Registry(), device="cpu")
    try:
        got = engine.generate([1, 2, 3], max_new_tokens=6, timeout=120).tokens
    finally:
        engine.stop()
    assert got == greedy_generate(trained, np.asarray([[1, 2, 3]]), 6)[0, 3:].tolist()
    # /generate mounts on the flight deck's exporter since the telemetry slice
    # (ROADMAP Queue A item 19a; served end to end in
    # tests/test_torch_flightdeck.py), and takes a traffic log since the
    # online loop's slice (item 18c)
    from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod

    assert install_http_endpoint(engine, path="/generate_unported_case") == \
        "/generate_unported_case"
    server_mod._EXTRA.pop("/generate_unported_case")
    from distkeras_tpu_torch.online import TrafficLog

    log = TrafficLog(str(tmp_path / "capture"))
    assert install_http_endpoint(engine, path="/generate_logged", traffic_log=log) == \
        "/generate_logged"
    server_mod._EXTRA.pop("/generate_logged")
    log.close()
    with pytest.raises(TypeError, match="decode_spec"):
        ServingEngine(torch.nn.Linear(2, 2), {}, device="cpu")


def test_default_device_raises_without_cuda(lm):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(lm[2], lm[3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(num_layers=1, num_slots=1, page_size=4, pages_per_slot=1, heads=2,
                     head_dim=8)


def test_frontend_matches_jax(monkeypatch):
    import dataclasses

    from distkeras_tpu.serving import frontend as jax_frontend
    from distkeras_tpu_torch.serving import frontend

    for request in (
        {"method": "GET", "query": "prompt=1,2,3&max_new_tokens=4&temperature=0.5&seed=9"
                                   "&speculative=false&eos_id=2"},
        {"method": "POST", "body": '{"prompt": [4, 5], "top_k": 3, "top_p": 0.9, '
                                   '"timeout_s": 2.5, "tenant": "acme"}',
         "headers": {"x-dk-request-id": "r1", "x-dk-trace-id": "t1"}},
    ):
        port, ref = frontend._parse_request(request), jax_frontend._parse_request(request)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for bad in ({"method": "GET", "query": "max_new_tokens=2"},
                {"method": "POST", "body": '{"prompt": [1], "top_p": 2.0}'}):
        with pytest.raises(ValueError):
            jax_frontend._parse_request(bad)
        with pytest.raises(ValueError):
            frontend._parse_request(bad)
    result = dict(request_id="r", prompt=[1], tokens=[2, 3], finish_reason="eos",
                  ttft_s=0.5, latency_s=1.0, trace_id="t")
    # the JAX package's keys and values, then the port's timings (0.0 unset)
    port = json.loads(frontend.GenerateResult(**result).to_json())
    timings = {k: port.pop(k) for k in ("queue_wait_s", "prefill_s", "device_s",
                                        "decode_device_s")}
    assert json.dumps(port) == jax_frontend.GenerateResult(**result).to_json()
    assert timings == dict.fromkeys(timings, 0.0)
    for flags in ('{"spec_tokens": 4, "num_slots": 8}', "not json", "[1]", None):
        if flags is None:
            monkeypatch.delenv("DISTKERAS_SERVE_FLAGS", raising=False)
        else:
            monkeypatch.setenv("DISTKERAS_SERVE_FLAGS", flags)
        assert frontend.serve_flags() == jax_frontend.serve_flags()
    queue = frontend.RequestQueue(2)
    queue.put("a")
    queue.put("b")
    with pytest.raises(QueueFull, match="capacity"):
        queue.put("c")
    assert queue.remove("a") and not queue.remove("a") and queue.pop() == "b"
    queue.requeue_front("b")
    assert len(queue) == 1 and queue.pop() == "b" and queue.pop() is None


def test_concurrent_submitters_under_a_short_switch_interval(lm, engines):
    """More submitting threads than cores, the interpreter switching
    threads every 10 µs: every request completes with its greedy tokens,
    and every slot and page comes back."""
    import sys
    import threading

    engine = engines["plain"]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 5) * 6]
    refs = [_ref(lm, p, 4) for p in prompts]
    got = [None] * len(prompts)

    def submit(i):
        got[i] = engine.generate(prompts[i], max_new_tokens=4, timeout=120).tokens

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == refs
    stats = _settled(engine)
    assert stats["active_slots"] == 0 and stats["pages_in_use"] == 0
    assert stats["queue_depth"] == 0
