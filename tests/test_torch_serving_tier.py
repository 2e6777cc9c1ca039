"""The port's serving tier (``serving/tier.py``) against
tests/test_serving_tier.py, on two or three engines of a tiny
``TransformerLM`` (vocab 23, dim 16, 2 layers, max_len 32) whose flax
parameters are carried over with ``params_from_flax``:

* the ``serving_tier_*`` schema renders byte for byte as the JAX package's
  golden Prometheus text;
* a replica chaos-killed mid-decode (``kill_replica``) loses nothing: every
  request completes with the JAX ``greedy_generate_module``'s tokens (what
  the JAX tier's failover test holds its tokens to), seeded sampled
  requests with their own tokens served alone, and the ledger bills each
  request once (tests/test_accounting.py's failover case);
* the probe walk (healthy, degraded, dead, resurrected) driven through
  ``probe_once``; a dead serve job is ``ReplicaDead`` at once, through a
  stub and through the port's daemon;
* a rolling hot-swap under load drops nothing and keeps one replica
  dispatchable; ``watch_and_swap`` and the tier's checkpoint watcher follow
  published steps, reject a rotted one at swap time, never surface a torn
  one, and survive a raising poll;
* deadline, shedding, the attempt cap, least-loaded dispatch, the stable
  request id, request validation and the ``/generate`` + ``/tier``
  endpoint;
* chaos off is stock: unset, the engine's loop crosses no site; armed with
  every key and firing none, the tokens are the unarmed run's bit for bit.

The daemon's ``serve_tier`` verb cases are in tests/test_torch_jobs.py.
The checkpoint steps here are the port's own (``save_checkpoint`` of a
``TrainState``); the engines run on the CPU, one torch thread."""

import json
import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models.generate import greedy_generate_module
from distkeras_tpu_torch import chaos, telemetry
from distkeras_tpu_torch import checkpoint as ckpt_mod
from distkeras_tpu_torch.checkpoint import CheckpointWatcher, write_manifest
from distkeras_tpu_torch.job_deployment import Job, PunchcardServer
from distkeras_tpu_torch.models import TransformerLM, params_from_flax
from distkeras_tpu_torch.serving import (
    GenerateRequest,
    GenerateResult,
    HttpReplica,
    LocalReplica,
    QueueFull,
    ReplicaDead,
    ServingEngine,
    ServingTier,
    TierDeadline,
    TierExhausted,
    TierSaturated,
    install_tier_endpoint,
    tier_metrics,
    watch_and_swap,
)
from distkeras_tpu_torch.telemetry import accounting
from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
from distkeras_tpu_torch.telemetry.metrics import Registry

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

VOCAB = 23
CFG = dict(vocab_size=VOCAB, dim=16, heads=2, num_layers=2, max_len=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9)


@pytest.fixture(autouse=True)
def clean_tier(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    telemetry.configure(True)
    accounting.configure(True)
    telemetry.metrics.reset()
    accounting.reset()
    correlate.set_run_id("tiertest")
    chaos.configure("")  # each test starts with chaos off, counters clear
    yield
    chaos.configure(None)
    server_mod.stop()
    server_mod.configure(None)
    telemetry.metrics.reset()
    accounting.configure(None)
    accounting.reset()
    correlate.set_run_id(None)
    telemetry.configure(None)


def _init(seed):
    jax_model = JaxLM(**CFG)
    params = jax_model.init(jax.random.PRNGKey(seed), np.zeros((1, 4), np.int32))["params"]
    model = TransformerLM(**CFG)
    return jax_model, params, model, params_from_flax(model, params)


@pytest.fixture(scope="module")
def lm():
    return _init(0)


@pytest.fixture(scope="module")
def lm2():
    return _init(9)


@pytest.fixture
def make_tier():
    """Tier factory that guarantees teardown (prober, watchers, engines)."""
    tiers = []

    def factory(replicas, **kw):
        kw.setdefault("registry", Registry())
        tier = ServingTier(replicas, **kw)
        tiers.append(tier)
        return tier

    yield factory
    for tier in tiers:
        tier.stop(close_replicas=True)


def _engines(lm, n, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 8)
    return [ServingEngine(lm[2], lm[3], registry=Registry(), device="cpu", **kw)
            for _ in range(n)]


_REFS = {}
#: every JAX reference decodes this many tokens from prompts of 3 or 5, so
#: that the module compiles two greedy programs in all
NEW = 6


def _ref(lm, prompt, steps):
    """The JAX greedy decode of ``prompt`` (memoised per parameters)."""
    key = (id(lm[1]), tuple(prompt), steps)
    if key not in _REFS:
        out = greedy_generate_module(lm[0], lm[1], np.asarray([prompt], np.int32), steps)
        _REFS[key] = out[0, len(prompt):].tolist()
    return _REFS[key]


def _ctr(registry, name):
    entry = registry.snapshot().get(name)
    return 0.0 if entry is None else float(entry.get("value") or 0.0)


def _dispatch_all(tier, requests, deadline_s=120.0):
    results = [None] * len(requests)

    def run(i):
        results[i] = tier.dispatch(requests[i], deadline_s=deadline_s)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


# ------------------------------------------------------------ metric schema


def test_tier_metrics_schema_golden():
    registry = Registry()
    m = tier_metrics(registry)
    m["requests"].inc(6)
    m["failovers"].inc(1)
    m["hedges"].inc(1)
    m["sheds"].inc(1)
    m["hot_swaps"].inc(2)
    m["roll_failures"].inc(1)
    m["deadline_expired"].inc(1)
    m["ckpt_rejected"].inc(1)
    m["replicas_healthy"].set(3)
    m["latency"].observe(0.25)
    m["attempts"].observe(1)
    m["attempts"].observe(3)
    golden = open(os.path.join(GOLDEN, "serving_tier_metrics.txt")).read()
    assert registry.to_prometheus(labels={"run_id": "fleet1234"}) == golden
    # get-or-create: a second call must hand back the same instruments
    assert tier_metrics(registry)["requests"] is m["requests"]


# ------------------------------------------------------- failover (chaos)


def test_failover_under_chaos_matches_jax_and_bills_once(lm, make_tier):
    """A replica chaos-killed mid-decode loses nothing: its in-flight
    requests re-run elsewhere, greedy ones with the JAX greedy decode's
    tokens, seeded sampled ones with their own tokens served alone; the
    ledger bills each request exactly once, failed attempts folded in."""
    registry = Registry()
    tier = make_tier(_engines(lm, 3), probe_interval=0.05,
                     default_deadline_s=120.0, registry=registry)
    tier.start()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 5, 5, 3, 3, 5)]
    requests = [GenerateRequest(prompt=p, max_new_tokens=NEW, tenant="acme" if i < 3 else "zen")
                for i, p in enumerate(prompts)]
    requests += [GenerateRequest(prompt=prompts[i], max_new_tokens=NEW, seed=40 + i,
                                 tenant="zen", **SAMPLED) for i in (0, 1)]
    # fire-once kill at the 2nd busy engine iteration: it lands on a
    # replica with requests actively decoding
    chaos.configure("11:kill_replica=2")
    results = _dispatch_all(tier, requests)
    chaos.configure("")

    for result, prompt in zip(results[:6], prompts):
        assert result is not None and result.finish_reason != "aborted"
        assert result.tokens == _ref(lm, prompt, NEW)
    alone = _engines(lm, 1)[0]
    try:
        for req, result in zip(requests[6:], results[6:]):
            assert result.finish_reason != "aborted"
            assert result.tokens == alone.submit(req).result(timeout=60).tokens
    finally:
        alone.stop()
    assert _ctr(registry, "serving_tier_failovers_total") >= 1
    assert list(tier.states().values()).count("dead") == 1
    fired = telemetry.metrics.snapshot().get("chaos_kill_replica_total")
    assert fired and fired["value"] == 1

    snap = registry.snapshot()
    routed = snap["serving_tier_routed_total"]["value"]
    attempts = snap["serving_tier_request_attempts"]
    payload = tier._acct.snapshot()
    assert sum(r["requests"] for r in payload["tenants"]) == routed == len(requests)
    extra = attempts["sum"] - attempts["count"]
    assert sum(r["failover_attempts"] for r in payload["tenants"]) == extra >= 1
    assert snap["accounting_requests_total"]["value"] == routed
    assert snap["accounting_failover_attempts_total"]["value"] == extra


def test_chaos_off_is_stock_and_armed_unfired_is_bitwise(lm, make_tier):
    """Unset, the engine's loop crosses no fault site; armed with every
    key at a count that never fires, the served tokens (greedy and
    sampled) equal the unarmed run's bit for bit."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (4, 6, 3)]
    requests = [GenerateRequest(prompt=p, max_new_tokens=5, seed=i, **(SAMPLED if i % 2 else {}))
                for i, p in enumerate(prompts)]

    def serve():
        tier = make_tier(_engines(lm, 2))
        return [r.tokens for r in _dispatch_all(tier, requests)]

    plain = serve()
    assert chaos.counts() == {}  # no site crossed with chaos off
    never = 10 ** 9
    chaos.configure(f"3:kill_epoch={never},kill_block={never},stall_block={never},"
                    "refuse_connect=0,drop_reply=0,drop_recv=0,tear_send=0,delay_send_ms=0,"
                    f"kill_replica={never},stall_http=0,kill_commit={never},"
                    f"delay_commit_ms=0,torn_ckpt={never},flip_ckpt={never},"
                    f"kill_rotate={never}")
    armed = serve()
    counts = chaos.counts()
    chaos.configure("")
    assert counts.get("replica", 0) > 0 and counts.get("http", 0) > 0  # crossed, never fired
    assert armed == plain


# ------------------------------------------------- probe state machine


def test_probe_walk_degraded_dead_resurrected(lm, make_tier):
    """Stalled health probes degrade a healthy replica; enough missed
    lease windows evict it to dead; a succeeding probe resurrects it."""
    fake = [0.0]
    tier = make_tier(_engines(lm, 2, num_slots=1), probe_timeout=0.01,
                     probe_misses=2, clock=lambda: fake[0])
    tier.probe_once()
    assert set(tier.states().values()) == {"healthy"}

    chaos.configure("7:stall_http=99,stall_secs=0.05")
    tier.probe_once()
    assert set(tier.states().values()) == {"degraded"}
    # a degraded replica still serves when no healthy one exists
    result = tier.dispatch(GenerateRequest(prompt=[1, 2, 3], max_new_tokens=2))
    assert result.finish_reason != "aborted"

    fake[0] += 60.0
    tier.probe_once()
    assert set(tier.states().values()) == {"dead"}
    with pytest.raises(TierSaturated):
        tier.dispatch(GenerateRequest(prompt=[1, 2], max_new_tokens=2))

    chaos.configure("")
    tier.probe_once()
    assert set(tier.states().values()) == {"healthy"}
    snap = tier.snapshot()
    assert snap["evictions"] >= 2 and snap["healthy"] == 2


def test_dead_serve_job_is_replica_dead_immediately(make_tier):
    class _DeadJob:
        def status(self):
            return {"status": "failed", "returncode": 1}

    replica = HttpReplica("127.0.0.1:9", name="crashed", job=_DeadJob())
    with pytest.raises(ReplicaDead):
        replica.probe(timeout=0.1)
    tier = make_tier([replica])
    tier.probe_once()
    assert tier.states() == {"crashed": "dead"}
    assert tier.snapshot()["replicas"][0]["last_error"].startswith(
        "replica crashed: serve job is failed")

    # the same through the port's daemon: a serve job whose process exited
    server = PunchcardServer(port=0, secret="s3cret")
    server.start()
    try:
        job = Job("127.0.0.1", server.port, secret="s3cret", script="raise SystemExit(3)\n")
        job.serve()
        replica = HttpReplica("127.0.0.1:9", name="exited", job=job)
        deadline = time.monotonic() + 30
        while job.status()["status"] == "serving" and time.monotonic() < deadline:
            time.sleep(0.05)
        with pytest.raises(ReplicaDead, match="serve job is failed"):
            replica.probe(timeout=0.1)
    finally:
        server.stop()


def test_probe_loop_survives_probe_exception(lm, make_tier, monkeypatch):
    tier = make_tier(_engines(lm, 1), probe_interval=0.01)
    calls = []
    real = ServingTier.probe_once

    def flaky(self):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("export flaked")
        return real(self)

    monkeypatch.setattr(ServingTier, "probe_once", flaky)
    tier.start()
    deadline = time.monotonic() + 30
    while len(calls) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(calls) >= 4
    with tier._cv:
        thread = tier._probe_thread
    assert thread is not None and thread.is_alive()


# -------------------------------------------------------- rolling hot-swap


def test_rolling_hot_swap_drops_nothing(lm, lm2, make_tier):
    """Roll the fleet to new params under live load: zero dropped
    requests, >= 1 replica dispatchable throughout, every result the old
    or the new parameters' JAX greedy decode."""
    registry = Registry()
    tier = make_tier(_engines(lm, 2), probe_interval=0.05, registry=registry)
    tier.start()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (3, 5, 3, 5, 3, 5, 3, 5)]
    refs_old = [_ref(lm, p, NEW) for p in prompts]
    refs_new = [_ref(lm2, p, NEW) for p in prompts]
    assert refs_old != refs_new  # the swap must be observable

    results = [None] * len(prompts)
    min_healthy = [99]
    stop_sampling = threading.Event()

    def sample():
        while not stop_sampling.wait(0.01):
            min_healthy[0] = min(min_healthy[0], tier.snapshot()["healthy"])

    def run(i):
        results[i] = tier.dispatch(GenerateRequest(prompt=prompts[i], max_new_tokens=NEW),
                                   deadline_s=120.0)

    sampler = threading.Thread(target=sample)
    sampler.start()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    swapped = tier.roll(lm2[2], lm2[3], timeout=60.0)
    for t in threads:
        t.join(timeout=120)
    stop_sampling.set()
    sampler.join(timeout=5)

    assert swapped == 2
    for i, result in enumerate(results):
        assert result is not None and result.finish_reason != "aborted"
        assert result.tokens in (refs_old[i], refs_new[i])
    assert min_healthy[0] >= 1
    assert _ctr(registry, "serving_tier_hot_swaps_total") == 2
    for i in (0, 1):
        post = tier.dispatch(GenerateRequest(prompt=prompts[i], max_new_tokens=NEW))
        assert post.tokens == refs_new[i]


def _publish_step(directory, step):
    """A committed AND published step: a final directory plus the manifest
    commit record the verified watcher requires."""
    os.makedirs(os.path.join(directory, f"step_{step}"))
    write_manifest(directory, step)


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_watch_and_swap_follows_committed_checkpoints(lm, lm2, tmp_path):
    registry = Registry()
    engine = ServingEngine(lm[2], lm[3], num_slots=2, page_size=8, registry=registry,
                           device="cpu")
    prompt = [1, 2, 3]
    _publish_step(str(tmp_path), 10)  # pre-existing: must NOT trigger a swap
    loaded = []

    def loader(step):
        loaded.append(step)
        return lm2[2], lm2[3]

    stopper = watch_and_swap(engine, str(tmp_path), loader, poll_interval=0.02)
    try:
        time.sleep(0.1)
        assert loaded == []  # baselined at construction
        _publish_step(str(tmp_path), 12)
        _wait(lambda: _ctr(registry, "serving_hot_swaps_total") >= 1)
    finally:
        stopper()
    assert loaded == [12]
    assert engine.generate(prompt, max_new_tokens=NEW).tokens == _ref(lm2, prompt, NEW)
    engine.stop()


def test_watch_and_swap_survives_raising_poll(lm, lm2, tmp_path, monkeypatch):
    registry = Registry()
    engine = ServingEngine(lm[2], lm[3], num_slots=2, page_size=8, registry=registry,
                           device="cpu")
    real_poll = ckpt_mod.CheckpointWatcher.poll
    calls = []

    def flaky_poll(self):
        calls.append(1)
        if len(calls) % 2 == 1:  # every other round blows up
            raise RuntimeError("transient fs flake")
        return real_poll(self)

    monkeypatch.setattr(ckpt_mod.CheckpointWatcher, "poll", flaky_poll)
    stopper = watch_and_swap(engine, str(tmp_path), lambda step: (lm2[2], lm2[3]),
                             poll_interval=0.02)
    try:
        _publish_step(str(tmp_path), 12)
        _wait(lambda: _ctr(registry, "serving_hot_swaps_total") >= 1)
    finally:
        stopper()
    assert _ctr(registry, "serving_hot_swaps_total") == 1
    assert len(calls) >= 2
    engine.stop()


def _train_state(center, epoch):
    from distkeras_tpu_torch.parallel.engine import TrainState

    return TrainState(center_params={k: v.detach().clone() for k, v in center.items()},
                      center_rule={}, local_params={}, opt_state={}, model_state={},
                      rule_local={}, rng=[torch.Generator()], epoch=epoch)


def _spec_equal(engine, model, params) -> bool:
    """Whether ``engine`` serves exactly ``params`` (every tensor the
    decode reads, bit for bit)."""
    from distkeras_tpu_torch.serving.engine import _resolve_spec

    want, got = _resolve_spec(model, params, engine.device), engine._spec
    pairs = [(got.tok, want.tok), (got.pos, want.pos)]
    for g, w in zip(got.blocks + [got.final_ln, got.head], want.blocks + [want.final_ln, want.head]):
        pairs += [(g[k], w[k]) for k in w]
    return all(torch.equal(g, w) for g, w in pairs)


def test_tier_watch_checkpoints_rejects_bad_steps_then_rolls(lm, lm2, make_tier, tmp_path,
                                                             monkeypatch):
    """The router's watcher: a step whose bytes rot after its manifest
    landed (``flip_ckpt``: sizes intact) is surfaced, fails the full
    re-verify at swap time and is rejected, the fleet keeping its
    parameters; a torn step (``torn_ckpt``: truncated) fails the watcher's
    fast size check and is never surfaced; the next clean step rolls into
    every replica, whose parameters are then the restored step's, bit for
    bit."""
    registry = Registry()
    engines = _engines(lm, 2)
    tier = make_tier(engines, probe_interval=0.05, registry=registry)
    tier.start()
    directory = str(tmp_path / "ckpt")
    loaded = []

    def loader(step):
        center = ckpt_mod.restore_center(directory, step)["center_params"]
        loaded.append((step, center))
        return lm2[2], center

    # the watcher polls only between publications: the damage lands on the
    # writer thread just after the manifest, and a poll in between (a loaded
    # host) would verify the step before it rots
    publishing, poll = threading.Lock(), CheckpointWatcher.poll

    def gated_poll(watcher):
        with publishing:
            return poll(watcher)

    monkeypatch.setattr(CheckpointWatcher, "poll", gated_poll)

    def publish(step, spec):
        with publishing:
            chaos.configure(spec)
            ckpt_mod.save_checkpoint(directory, _train_state(lm2[3], step), step)
            ckpt_mod.wait_until_finished()
            chaos.configure("")

    tier.watch_checkpoints(directory, loader, poll_interval=0.02)
    publish(1, "5:flip_ckpt=0")
    assert _wait(lambda: _ctr(registry, "serving_checkpoint_rejected_total") >= 1)
    publish(2, "5:torn_ckpt=0")
    time.sleep(0.3)  # fifteen polls: the torn step is never surfaced
    assert _ctr(registry, "serving_checkpoint_rejected_total") == 1 and not loaded
    assert all(_spec_equal(e, lm[2], lm[3]) for e in engines)  # the fleet kept its params
    publish(3, "")
    assert _wait(lambda: _ctr(registry, "serving_tier_hot_swaps_total") >= 2)
    assert _ctr(registry, "serving_checkpoint_rejected_total") == 1
    assert _ctr(registry, "serving_tier_roll_failures_total") == 0
    assert [s for s, _ in loaded] == [3]
    for engine in engines:
        assert _spec_equal(engine, lm2[2], loaded[0][1])
    prompt = [2, 4, 6]
    assert tier.dispatch(GenerateRequest(prompt=prompt, max_new_tokens=NEW)).tokens == \
        _ref(lm2, prompt, NEW)


def test_checkpoint_watcher_reports_newest_once(tmp_path):
    d = str(tmp_path)
    _publish_step(d, 3)
    watcher = CheckpointWatcher(d)
    assert watcher.poll() is None  # baselined at the pre-existing step
    _publish_step(d, 7)
    assert watcher.poll() == 7
    assert watcher.poll() is None  # reported once
    _publish_step(d, 5)  # older than anything reported
    assert watcher.poll() is None
    assert CheckpointWatcher(d, start_after=-1).poll() == 7
    os.makedirs(os.path.join(d, "step_9"))  # no manifest: never surfaced
    assert watcher.poll() is None


# --------------------------------------- deadline / shedding / attempt cap


class _StubHandle:
    def __init__(self, result):
        self._result = result

    def result(self, timeout=None):
        return self._result


class _StubReplica:
    """Scriptable replica: fixed probe stats, queued submit outcomes."""

    def __init__(self, name, stats=None, outcomes=None):
        self.name = name
        self.stats = stats or {}
        self.outcomes = list(outcomes or [])
        self.submitted = []

    def probe(self, timeout=1.0):
        return dict(self.stats)

    def submit(self, request):
        self.submitted.append(request)
        outcome = self.outcomes.pop(0) if self.outcomes else "ok"
        if isinstance(outcome, Exception):
            raise outcome
        if outcome == "ok":
            return _StubHandle(GenerateResult(request_id=request.request_id,
                                              prompt=request.prompt, tokens=[7],
                                              finish_reason="length"))
        return _StubHandle(GenerateResult(request_id=request.request_id, prompt=request.prompt,
                                          tokens=[], finish_reason="aborted"))

    def cancel(self, handle):
        return True

    def close(self):
        pass


def test_deadline_expires_at_the_router(make_tier):
    registry = Registry()
    tier = make_tier([_StubReplica("a")], registry=registry)
    with pytest.raises(TierDeadline):
        tier.dispatch(GenerateRequest(prompt=[1], max_new_tokens=2), deadline_s=0.0)
    assert _ctr(registry, "serving_tier_deadline_expired_total") == 1


def test_saturated_tier_sheds(make_tier):
    registry = Registry()
    tier = make_tier([_StubReplica("a", outcomes=[QueueFull("full")])], registry=registry)
    with pytest.raises(TierSaturated):
        tier.dispatch(GenerateRequest(prompt=[1], max_new_tokens=2))
    assert _ctr(registry, "serving_tier_sheds_total") == 1


def test_attempt_cap_exhausts(make_tier):
    registry = Registry()
    rep = _StubReplica("a", outcomes=["aborted"] * 5)
    tier = make_tier([rep], max_attempts=3, backoff_s=0.001, backoff_cap_s=0.002,
                     registry=registry)
    with pytest.raises(TierExhausted):
        tier.dispatch(GenerateRequest(prompt=[1], max_new_tokens=2), deadline_s=30.0)
    assert len(rep.submitted) == 3
    assert _ctr(registry, "serving_tier_failovers_total") == 3


def test_least_loaded_dispatch_prefers_idle_replica(make_tier):
    busy = _StubReplica("busy", stats={"queue_depth": 5, "active_slots": 2})
    idle = _StubReplica("idle", stats={"queue_depth": 0, "active_slots": 0})
    tier = make_tier([busy, idle])
    result = tier.dispatch(GenerateRequest(prompt=[1], max_new_tokens=2))
    assert result.finish_reason == "length"
    assert not busy.submitted and len(idle.submitted) == 1


def test_request_id_is_stable_across_failover(make_tier):
    rep = _StubReplica("a", outcomes=["aborted", "ok"])
    tier = make_tier([rep], backoff_s=0.001, backoff_cap_s=0.002)
    tier.dispatch(GenerateRequest(prompt=[1], max_new_tokens=2), deadline_s=30.0)
    assert len(rep.submitted) == 2
    ids = {r.request_id for r in rep.submitted}
    assert len(ids) == 1 and ids != {""}
    assert all(r.timeout_s and r.timeout_s <= 30.0 for r in rep.submitted)


def test_request_validation_bounds():
    GenerateRequest(prompt=[1], top_p=0.5).validate()
    for bad in (dict(top_k=-1), dict(top_p=1.5), dict(top_p=-0.1), dict(timeout_s=0.0)):
        with pytest.raises(ValueError):
            GenerateRequest(prompt=[1], **bad).validate()


def test_local_replica_cancel_confirms(lm):
    """An in-process retry is licensed only once the engine provably
    stopped the request: ``cancel`` returns once its handle resolved."""
    engine = _engines(lm, 1, num_slots=1)[0]
    replica = LocalReplica(engine, name="solo")
    try:
        running = replica.submit(GenerateRequest(prompt=[1, 2], max_new_tokens=25))
        queued = replica.submit(GenerateRequest(prompt=[3, 4], max_new_tokens=2))
        assert replica.cancel(queued) and queued.done()
        assert queued.result(timeout=0).finish_reason == "aborted"
        assert replica.cancel(running) and running.done()
    finally:
        replica.close()


# ------------------------------------------------------------ HTTP endpoint


def test_tier_endpoint_routes_and_reports(lm, make_tier):
    server_mod.configure(0)
    addr = telemetry.flightdeck.ensure_server()
    tier = make_tier(_engines(lm, 2))
    install_tier_endpoint(tier)
    prompt = [2, 4, 6]
    body = json.dumps({"prompt": prompt, "max_new_tokens": NEW}).encode()
    req = urllib.request.Request(f"http://{addr}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        payload = json.loads(resp.read().decode("utf-8"))
    assert payload["tokens"] == _ref(lm, prompt, NEW)
    assert payload["finish_reason"] in ("length", "eos")
    with urllib.request.urlopen(f"http://{addr}/tier", timeout=10) as resp:
        snap = json.loads(resp.read().decode("utf-8"))
    assert snap["healthy"] == 2
    assert [r["state"] for r in snap["replicas"]] == ["healthy"] * 2
