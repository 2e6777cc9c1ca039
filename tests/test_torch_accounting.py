"""The port's per-tenant ledger, against tests/test_accounting.py: the
aggregate ``accounting_*`` schema against the JAX package's golden
Prometheus text, the golden bill's snapshot equal to the JAX ledger's,
top-K eviction conserving into ``__other__``, the decayed rolling rate,
bucket-exact fleet merges equal to JAX's, the ``/ledger`` endpoint and its
disabled shape, and the serving engine's billing: tenant-summed decode
tokens equal ``serving_tokens_total`` exactly under concurrent mixed
tenants (tokens held to the JAX greedy decode), speculative splits conserve
against the spec counters, ``DISTKERAS_ACCOUNTING=0`` leaves no ledger and
the same tokens, and the billing costs a fixed count of ledger calls a step
on host values only (no tensor reaches the ledger, none is read inside a
billing call).  The Punchcard daemon's ``ledger_status`` verb serves the
daemon's own ledger.  The router's failover billing waits for the serving
tier (ROADMAP Queue A item 18b)."""

import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import TransformerLM as JaxLM
from distkeras_tpu.models.generate import greedy_generate_module
from distkeras_tpu.telemetry import accounting as jax_accounting
from distkeras_tpu.telemetry.metrics import Registry as JaxRegistry
from distkeras_tpu_torch import sanitizer, telemetry
from distkeras_tpu_torch.models import TransformerLM, params_from_flax
from distkeras_tpu_torch.sanitizer import transfer
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.telemetry import accounting
from distkeras_tpu_torch.telemetry.accounting import (
    OTHER_TENANT,
    UNTAGGED_TENANT,
    TenantLedger,
    merge_ledgers,
)
from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
from distkeras_tpu_torch.telemetry.metrics import Registry

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

VOCAB = 23
CFG = dict(vocab_size=VOCAB, dim=16, heads=2, num_layers=2, max_len=32)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def clean_accounting(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    telemetry.configure(True)
    accounting.configure(True)
    telemetry.metrics.reset()
    accounting.reset()
    correlate.set_run_id("accttest")
    yield
    server_mod.stop()
    server_mod.configure(None)
    telemetry.metrics.reset()
    accounting.reset()
    correlate.set_run_id(None)
    accounting.configure(None)
    telemetry.configure(None)
    sanitizer.configure(None)


@pytest.fixture(scope="module")
def lm():
    jax_model = JaxLM(**CFG)
    params = jax_model.init(jax.random.PRNGKey(0), np.zeros((1, 4), np.int32))["params"]
    model = TransformerLM(**CFG)
    return jax_model, params, model, params_from_flax(model, params)


@pytest.fixture
def make_engine():
    engines = []

    def factory(model, params, **kw):
        kw.setdefault("num_slots", 3)
        kw.setdefault("page_size", 8)
        kw.setdefault("registry", Registry())
        engine = ServingEngine(model, params, device="cpu", **kw)
        engines.append(engine)
        return engine

    yield factory
    for engine in engines:
        engine.stop()


def _ref(lm, prompt, steps):
    out = greedy_generate_module(lm[0], lm[1], np.asarray([prompt], np.int32), steps)
    return np.asarray(out)[0, len(prompt):].tolist()


def _ctr(registry, name):
    entry = registry.snapshot().get(name)
    return 0.0 if entry is None else float(entry.get("value") or 0.0)


def _rows(payload):
    return {r["tenant"]: r for r in payload["tenants"]}


# ------------------------------------------------------------ metric schema


def _golden_bill(registry, ledger_cls=TenantLedger):
    """The JAX test's deterministic billing sequence (fixed clock: nothing
    decays, nothing races), on either package's ledger."""
    ledger = ledger_cls(registry, capacity=4, clock=lambda: 100.0)
    ledger.admit("acme", prompt_tokens=5, queue_wait_s=0.003, device_s=0.25)
    ledger.decode("acme", tokens=3, device_s=0.05)
    ledger.speculative("acme", accepted=2, rejected=1)
    ledger.release("acme", pages=4, held_s=0.5)
    ledger.request("acme", attempts=2, latency_s=0.3)
    ledger.admit("zen", prompt_tokens=2, queue_wait_s=0.2, device_s=0.1)
    ledger.decode("zen", tokens=1, device_s=0.02)
    ledger.release("zen", pages=2, held_s=0.25)
    ledger.request("zen")
    return ledger


def test_accounting_metrics_schema_golden():
    registry = Registry()
    _golden_bill(registry)
    golden = open(os.path.join(GOLDEN, "accounting_metrics.txt")).read()
    assert registry.to_prometheus(labels={"run_id": "fleet1234"}) == golden


def test_golden_bill_snapshot_shape():
    registry = Registry()
    ledger = _golden_bill(registry)
    payload = ledger.snapshot()
    # the same bill on the JAX ledger snapshots to the same table
    assert payload == _golden_bill(JaxRegistry(), jax_accounting.TenantLedger).snapshot()
    rows = _rows(payload)
    assert set(rows) == {"acme", "zen"}
    acme = rows["acme"]
    assert acme["prefill_tokens"] == 5 and acme["decode_tokens"] == 4
    assert acme["spec_accepted"] == 2 and acme["spec_rejected"] == 1
    assert acme["failover_attempts"] == 1 and acme["requests"] == 1
    assert acme["page_seconds"] == pytest.approx(2.0)
    assert acme["device_seconds"]["prefill"] == pytest.approx(0.25)
    assert acme["share"] == pytest.approx(9 / 13)
    assert payload["totals"]["tokens"] == 13
    assert payload["totals"]["requests"] == 2
    assert [r["tenant"] for r in payload["tenants"]] == ["acme", "zen"]
    assert _ctr(registry, "accounting_decode_tokens_total") == 6
    assert _ctr(registry, "accounting_prefill_tokens_total") == 7
    assert _ctr(registry, "accounting_failover_attempts_total") == 1


# ------------------------------------------------- ledger unit behaviour


def test_topk_eviction_keeps_cardinality_fixed_and_conserves():
    t = [0.0]
    registry = Registry()
    ledger = TenantLedger(registry, capacity=2, clock=lambda: t[0])
    ledger.admit("a", prompt_tokens=8, queue_wait_s=0.0, device_s=0.0)
    ledger.admit("b", prompt_tokens=2, queue_wait_s=0.0, device_s=0.0)
    ledger.admit("c", prompt_tokens=4, queue_wait_s=0.0, device_s=0.0)
    rows = _rows(ledger.snapshot())
    assert set(rows) == {"a", "c", OTHER_TENANT}
    assert rows[OTHER_TENANT]["prefill_tokens"] == 2
    assert rows[OTHER_TENANT]["decode_tokens"] == 1
    payload = ledger.snapshot()
    assert payload["totals"]["tokens"] == 8 + 2 + 4 + 3
    assert payload["evictions"] == 1
    assert _ctr(registry, "accounting_tenant_evictions_total") == 1
    for i in range(20):
        ledger.admit(f"burst{i}", prompt_tokens=1, queue_wait_s=0.0, device_s=0.0)
    assert len(ledger.snapshot()["tenants"]) <= ledger.capacity + 1
    assert _ctr(registry, "accounting_tenants_tracked") <= ledger.capacity


def test_rolling_rate_decays_and_ranks_eviction():
    t = [0.0]
    ledger = TenantLedger(Registry(), capacity=8, tau_s=30.0, clock=lambda: t[0])
    ledger.admit("hot", prompt_tokens=29, queue_wait_s=0.0, device_s=0.0)
    assert ledger.rolling_rate("hot") == pytest.approx(1.0)
    t[0] += 30.0
    assert ledger.rolling_rate("hot") == pytest.approx(np.exp(-1.0))
    assert ledger.rolling_rate("nobody") == 0.0
    assert ledger.rolling_rate("hot", unit="requests") == 0.0
    with pytest.raises(ValueError):
        ledger.rolling_rate("hot", unit="bogus")


def test_untagged_requests_share_one_bucket():
    ledger = TenantLedger(Registry(), clock=lambda: 0.0)
    ledger.admit("", prompt_tokens=3, queue_wait_s=0.0, device_s=0.0)
    ledger.admit(None, prompt_tokens=2, queue_wait_s=0.0, device_s=0.0)
    rows = _rows(ledger.snapshot())
    assert set(rows) == {UNTAGGED_TENANT}
    assert rows[UNTAGGED_TENANT]["prefill_tokens"] == 5


def test_merge_ledgers_is_bucket_exact():
    snap = _golden_bill(Registry()).snapshot()
    merged = merge_ledgers([snap, snap])
    assert merged == jax_accounting.merge_ledgers([snap, snap])
    rows = _rows(merged)
    assert rows["acme"]["prefill_tokens"] == 10
    assert rows["acme"]["decode_tokens"] == 8
    assert merged["totals"]["tokens"] == 2 * snap["totals"]["tokens"]
    assert sum(r["share"] for r in merged["tenants"]) == pytest.approx(1.0)
    assert rows["acme"]["queue_p99_s"] == pytest.approx(_rows(snap)["acme"]["queue_p99_s"])
    assert merge_ledgers([]) == merge_ledgers([{}])


# ------------------------------------------------ conservation (engine)


def test_conservation_under_concurrent_mixed_tenants(lm, make_engine):
    """Tenant-summed ledger tokens equal ``serving_tokens_total`` exactly,
    with three tenants interleaving across a shared continuous batch."""
    registry = Registry()
    engine = make_engine(lm[2], lm[3], registry=registry)
    rng = np.random.default_rng(7)
    jobs = [("acme", rng.integers(0, VOCAB, size=n).tolist(), steps)
            for n, steps in ((3, 6), (5, 4), (4, 5))]
    jobs += [("zen", rng.integers(0, VOCAB, size=n).tolist(), steps)
             for n, steps in ((6, 3), (3, 6))]
    jobs += [("", rng.integers(0, VOCAB, size=4).tolist(), 4)]
    results = [None] * len(jobs)

    def run(i):
        tenant, prompt, steps = jobs[i]
        results[i] = engine.generate(prompt, steps, tenant=tenant, timeout=120.0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert all(r is not None for r in results)
    for (tenant, prompt, steps), result in zip(jobs, results):
        assert result.tokens == _ref(lm, prompt, steps)

    snap = registry.snapshot()
    payload = engine._ledger.snapshot()
    rows = _rows(payload)
    assert set(rows) == {"acme", "zen", UNTAGGED_TENANT}
    decode_sum = sum(r["decode_tokens"] for r in payload["tenants"])
    prefill_sum = sum(r["prefill_tokens"] for r in payload["tenants"])
    assert decode_sum == snap["serving_tokens_total"]["value"]
    assert prefill_sum == sum(len(p) for _, p, _ in jobs)
    assert snap["accounting_decode_tokens_total"]["value"] == decode_sum
    assert snap["accounting_prefill_tokens_total"]["value"] == prefill_sum
    assert snap["accounting_queue_wait_seconds"]["count"] == len(jobs)
    assert all(r["page_seconds"] > 0.0 for r in payload["tenants"])
    assert rows["acme"]["device_seconds"]["prefill"] > 0.0
    assert rows["acme"]["device_seconds"]["decode"] > 0.0


def test_spec_conservation(lm, make_engine):
    registry = Registry()
    # draft IS the target: every proposal accepted, maximum spec traffic
    engine = make_engine(lm[2], lm[3], draft_model=lm[2], draft_params=lm[3],
                         spec_tokens=3, registry=registry)
    rng = np.random.default_rng(11)
    prompts = {"acme": rng.integers(0, VOCAB, size=4).tolist(),
               "zen": rng.integers(0, VOCAB, size=5).tolist()}
    for tenant, prompt in prompts.items():
        result = engine.generate(prompt, 6, tenant=tenant, timeout=120.0)
        assert result.tokens == _ref(lm, prompt, 6)
    snap = registry.snapshot()
    payload = engine._ledger.snapshot()
    accepted = sum(r["spec_accepted"] for r in payload["tenants"])
    rejected = sum(r["spec_rejected"] for r in payload["tenants"])
    assert accepted == snap["serving_spec_accepted_total"]["value"]
    assert accepted + rejected == snap["serving_spec_proposed_total"]["value"]
    decode_sum = sum(r["decode_tokens"] for r in payload["tenants"])
    assert decode_sum == snap["serving_tokens_total"]["value"]


# ------------------------------------------------- flag-off: fully inert


def test_flag_off_engine_has_no_ledger_and_the_same_tokens(lm, make_engine):
    prompt = [3, 1, 4, 1]
    accounting.configure(False)
    registry_off = Registry()
    engine_off = make_engine(lm[2], lm[3], registry=registry_off)
    assert engine_off._ledger is None
    assert accounting.maybe_ledger(registry_off) is None
    off = engine_off.generate(prompt, 5, tenant="acme", timeout=60).tokens
    assert not any(name.startswith("accounting_") for name in registry_off.snapshot())

    accounting.configure(True)
    engine_on = make_engine(lm[2], lm[3], registry=Registry())
    assert engine_on._ledger is not None
    assert engine_on.generate(prompt, 5, tenant="acme", timeout=60).tokens == off


def test_flag_env_resolution(monkeypatch):
    for raw, expect in (("0", False), ("1", True)):
        accounting.configure(None)
        jax_accounting.configure(None)
        monkeypatch.setenv("DISTKERAS_ACCOUNTING", raw)
        assert accounting._flag() is jax_accounting._flag() is expect
        assert accounting.enabled() is expect
    monkeypatch.delenv("DISTKERAS_ACCOUNTING")
    accounting.configure(None)
    jax_accounting.configure(None)
    assert accounting.enabled()  # unset defaults ON (telemetry is on)
    telemetry.configure(False)
    assert not accounting.enabled()  # telemetry master switch wins
    telemetry.configure(True)
    accounting.configure(True)


def test_billing_is_a_fixed_count_of_host_calls_a_step(lm, make_engine):
    """The billing path's cost, counted instead of timed: per plain decode
    step one ``decode`` call per active slot, one ``admit`` per request and
    one ``release`` per retirement; every argument a host value (no tensor
    reaches the ledger) and every call run under a strict transfer guard, so
    a tensor read inside a billing call would raise."""
    sanitizer.configure("strict")
    engine = make_engine(lm[2], lm[3], registry=Registry())
    ledger = engine._ledger
    calls = {"admit": 0, "decode": 0, "release": 0, "speculative": 0}
    bad = []

    def counted(name, fn):
        def wrapper(tenant, **kw):
            calls[name] += 1
            bad.extend(k for k, v in kw.items() if isinstance(v, torch.Tensor)
                       or not isinstance(v, (int, float)))
            with transfer.guard(f"ledger.{name}"):
                return fn(tenant, **kw)
        return wrapper

    for name in calls:
        setattr(ledger, name, counted(name, getattr(ledger, name)))
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    results = []
    ths = [threading.Thread(target=lambda p=p, t=t: results.append(
        engine.generate(p, 4, tenant=t, timeout=60))) for p, t in zip(prompts, ("a", "b", "a"))]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert len(results) == 3 and not bad and sanitizer.violations() == []
    snap = engine._ledger.snapshot()
    decoded = sum(r["decode_tokens"] for r in snap["tenants"])
    assert calls["admit"] == calls["release"] == 3 and calls["speculative"] == 0
    # each request's first token bills at admission, every later one in a
    # decode call of its own: one call per active slot per step
    assert calls["decode"] == decoded - 3 == 3 * (4 - 1)


# ----------------------------------------------------- /ledger endpoint


def test_ledger_endpoint_live_scrape():
    ledger = accounting.ledger_for()  # process-global registry
    ledger.admit("acme", prompt_tokens=5, queue_wait_s=0.01, device_s=0.1)
    server_mod.configure(0)
    addr = server_mod.ensure_server()
    assert addr is not None
    with urllib.request.urlopen(f"http://{addr}/ledger", timeout=10) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("application/json")
        payload = json.loads(r.read().decode("utf-8"))
    assert payload["enabled"] is True
    assert _rows(payload)["acme"]["prefill_tokens"] == 5

    accounting.configure(False)
    with urllib.request.urlopen(f"http://{addr}/ledger", timeout=10) as r:
        off = json.loads(r.read().decode("utf-8"))
    assert off == {"enabled": False, "tenants": []}
    accounting.configure(True)


def test_ledger_view_disabled_shape():
    accounting.configure(False)
    ctype, body, status = accounting.ledger_view()
    assert status == 200 and ctype == "application/json"
    assert json.loads(body) == {"enabled": False, "tenants": []}
    jax_accounting.configure(False)
    try:
        assert jax_accounting.ledger_view() == (ctype, body, status)
    finally:
        jax_accounting.configure(None)


def test_daemon_ledger_status_verb_serves_its_own_ledger():
    from distkeras_tpu_torch.job_deployment import Job, PunchcardServer

    ledger = accounting.ledger_for()  # the process-global registry's
    ledger.admit("acme", prompt_tokens=9, queue_wait_s=0.01, device_s=0.1)
    ledger.admit("zen", prompt_tokens=2, queue_wait_s=0.02, device_s=0.05)
    daemon = PunchcardServer(port=0, secret="s3cret")
    daemon.start()
    try:
        reply = Job("127.0.0.1", daemon.port, secret="s3cret").ledger_status()
    finally:
        daemon.stop()
    assert reply["status"] == "ok" and reply["enabled"] is True
    assert reply["jobs"] == 0  # no live jobs: the daemon's own process
    rows = _rows(reply)
    assert rows["acme"]["prefill_tokens"] == 9 and rows["zen"]["prefill_tokens"] == 2
    assert [r["tenant"] for r in reply["tenants"]][:2] == ["acme", "zen"]  # hottest first
