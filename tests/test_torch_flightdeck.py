"""The port's flight deck, against tests/test_flightdeck.py (less its daemon
case, which waits for the fleet's control plane): the bounded
flight-recorder ring (wrap order, overhead pin, disabled-path silence), the
live HTTP exporter (``/metrics`` ``/healthz`` ``/vars`` ``/trace``, answered
mid-fit under concurrent scrapes; ``/healthz``'s sanitizer mode and
violation counts as the JAX exporter's; ``/ledger``), ``run_id`` correlation (minting, env
inheritance, span stamping, the labelled Prometheus golden), blackbox
crash dumps (unit, and a real watchdog halt through a trainer), the rollup
ring's windowed reads against the JAX package's, and ``/generate``
(``install_http_endpoint``) on a tiny CPU serving engine, whose tokens
must be ``greedy_generate``'s.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import MLP, TransformerLM, TrainedModel, greedy_generate
from distkeras_tpu_torch.serving import ServingEngine, install_http_endpoint
from distkeras_tpu_torch.telemetry.dynamics import TrainingDiverged
from distkeras_tpu_torch.telemetry.flightdeck import correlate, rollup
from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
from distkeras_tpu_torch.telemetry.flightdeck.recorder import (
    FlightRecorder,
    blackbox_dump,
    recorder,
)
from distkeras_tpu_torch.telemetry.metrics import Registry, prometheus_from_snapshot
from distkeras_tpu_torch.telemetry.trace import Tracer

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def clean_flightdeck(tmp_path, monkeypatch):
    """Each test runs enabled, correlated under a fixed run_id, with empty
    tracer/registry/ring, and leaves every global env-driven again."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setattr(telemetry.dynamics, "_LAST_SUMMARY", None)
    telemetry.configure(True)
    telemetry.trace.reset()
    telemetry.metrics.reset()
    recorder.reset()
    correlate.set_run_id("testrun")
    yield
    server_mod.stop()
    server_mod.configure(None)
    telemetry.trace.reset()
    telemetry.metrics.reset()
    recorder.reset()
    correlate.set_run_id(None)
    telemetry.dynamics.configure()
    telemetry.configure(None)


def _get(addr, path, timeout=10):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout) as r:
        return r.status, r.read().decode("utf-8")


def _post(addr, path, payload, timeout=120):
    req = urllib.request.Request(f"http://{addr}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode("utf-8")


# -------------------------------------------------------------------- ring

def test_ring_wraps_and_keeps_newest_oldest_first():
    ring = FlightRecorder(capacity=8)
    for i in range(20):
        ring.record_metric(f"m{i}", float(i))
    evs = ring.events()
    assert [e["name"] for e in evs] == [f"m{i}" for i in range(12, 20)]
    assert all(e["kind"] == "metric" for e in evs)
    perfs = [e["perf"] for e in evs]
    assert perfs == sorted(perfs)


def test_ring_partial_fill_and_reset():
    ring = FlightRecorder(capacity=8)
    ring.record_span({"name": "epoch", "ph": "X", "ts": 0.0, "dur": 1.0, "args": {}})
    ring.record_watchdog({"action": "warn", "epoch": 3})
    evs = ring.events()
    assert [e["kind"] for e in evs] == ["span", "watchdog"]
    assert evs[0]["event"]["name"] == "epoch"
    assert ring.last_spans() == {"epoch": evs[0]["unix"]}
    assert ring.watchdog_state() == {"action": "warn", "epoch": 3}
    assert ring.last_event_unix() == evs[-1]["unix"]
    ring.reset()
    assert ring.events() == [] and ring.last_event_unix() is None
    assert ring.watchdog_state() is None


def test_ring_record_overhead_pin():
    ring = FlightRecorder(capacity=1024)
    n = 20000
    d = {}
    t0 = time.perf_counter()
    for i in range(n):
        d["k"] = i
    dict_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        ring.record_metric("m", 1.0)
    ring_t = time.perf_counter() - t0
    assert ring_t < max(150 * dict_t, 0.05), (
        f"ring record cost {ring_t:.4f}s vs dict store {dict_t:.4f}s")


def test_disabled_telemetry_feeds_nothing_into_the_ring():
    telemetry.configure(False)
    recorder.reset()
    telemetry.metrics.counter("c").inc()
    with telemetry.trace.span("epoch"):
        pass
    assert recorder.events() == []


def test_trace_export_places_instants_on_span_axis():
    ring = FlightRecorder(capacity=8)
    ring.record_span({"name": "epoch", "ph": "X", "ts": 100.0, "dur": 5.0, "pid": 1, "tid": 1,
                      "args": {}})
    ring.record_metric("commits_total", 2.0)
    payload = ring.trace_export()
    assert payload["displayTimeUnit"] == "ms"
    spans = [e for e in payload["traceEvents"] if e.get("ph") == "X"]
    instants = [e for e in payload["traceEvents"] if e.get("ph") == "i"]
    assert spans[0]["ts"] == 100.0
    assert instants[0]["name"] == "metric:commits_total"
    assert instants[0]["args"] == {"value": 2.0} and instants[0]["ts"] >= 0.0


# ------------------------------------------------------------- correlation

def test_run_id_minting_env_inheritance_and_force(monkeypatch):
    correlate.set_run_id(None)
    monkeypatch.delenv("DISTKERAS_RUN_ID", raising=False)
    assert correlate.current() is None  # never mints
    rid = correlate.run_id()
    assert len(rid) == 12 and correlate.current() == rid
    assert correlate.run_id() == rid
    correlate.set_run_id(None)
    monkeypatch.setenv("DISTKERAS_RUN_ID", "inherited01")
    assert correlate.current() == "inherited01" and correlate.run_id() == "inherited01"


def test_correlated_tracer_stamps_run_id_and_feeds_ring():
    with telemetry.trace.span("epoch", epoch=0):
        pass
    ev = telemetry.trace.export()["traceEvents"][0]
    assert ev["args"] == {"epoch": 0, "run_id": "testrun"}
    ring = recorder.events()
    assert [e["kind"] for e in ring] == ["span"]
    assert ring[0]["event"]["args"]["run_id"] == "testrun"


def test_injected_tracer_stays_pure():
    tr = Tracer(pid=0)
    with tr.span("epoch", epoch=0):
        pass
    assert tr.export()["traceEvents"][0]["args"] == {"epoch": 0}
    assert recorder.events() == []


def test_flush_carries_run_id():
    telemetry.metrics.counter("c").inc()
    _, metrics_path = telemetry.flush()
    line = json.loads(open(metrics_path).read().splitlines()[-1])
    assert line["run_id"] == "testrun"


def test_prometheus_run_id_label_golden():
    reg = Registry()
    reg.counter("jax_compiles_total", help="compile events").inc(3)
    reg.gauge("samples_per_sec_per_chip").set(1234.5)
    h = reg.histogram("phase_step_seconds", help="step phase", buckets=(0.001, 0.01, 0.1))
    h.observe(0.0005)
    h.observe(0.05)
    golden = open(os.path.join(GOLDEN, "flightdeck_metrics.txt")).read()
    assert reg.to_prometheus(labels={"run_id": "fleet1234"}) == golden
    assert "run_id" not in reg.to_prometheus()


def test_prometheus_from_snapshot_carries_labels():
    snap = {"dynamics_grad_norm": {"type": "gauge", "value": 2.5, "mean": 2.0}}
    text = prometheus_from_snapshot(snap, labels={"run_id": "r"})
    assert 'dynamics_grad_norm{agg="max",run_id="r"} 2.5' in text
    assert 'dynamics_grad_norm{agg="mean",run_id="r"} 2' in text


# ---------------------------------------------------------------- exporter

def test_http_port_gate(monkeypatch):
    for raw, want in (("", None), ("off", None), ("false", None), ("no", None), ("0", 0),
                      ("9123", 9123)):
        server_mod.configure(None)
        if raw:
            monkeypatch.setenv("DISTKERAS_TELEMETRY_HTTP", raw)
        else:
            monkeypatch.delenv("DISTKERAS_TELEMETRY_HTTP", raising=False)
        assert server_mod.http_port() == want, raw


def test_exporter_off_by_default_and_when_disabled(monkeypatch):
    monkeypatch.delenv("DISTKERAS_TELEMETRY_HTTP", raising=False)
    server_mod.configure(None)
    assert telemetry.flightdeck.ensure_server() is None
    server_mod.configure(0)
    telemetry.configure(False)
    assert telemetry.flightdeck.ensure_server() is None
    assert telemetry.flightdeck.address() is None


def test_exporter_endpoints_and_discovery_file(tmp_path):
    server_mod.configure(0)
    assert telemetry.flightdeck.activate() == "testrun"
    addr = telemetry.flightdeck.address()
    assert addr is not None and addr.startswith("127.0.0.1:")
    assert telemetry.flightdeck.ensure_server() == addr  # idempotent
    telemetry.metrics.counter("commits_total").inc(3)
    with telemetry.trace.span("epoch", epoch=0):
        pass
    code, text = _get(addr, "/metrics")
    assert code == 200 and 'commits_total{run_id="testrun"} 3' in text
    code, text = _get(addr, "/healthz")
    health = json.loads(text)
    assert (code, health["status"], health["run_id"]) == (200, "ok", "testrun")
    assert health["pid"] == os.getpid() and "epoch" in health["last_spans"]
    assert health["last_event_unix"] is not None and health["uptime_seconds"] >= 0
    assert health["sanitizer"] == {"mode": "off", "violations": {}}
    code, text = _get(addr, "/vars")
    v = json.loads(text)
    assert (code, v["run_id"]) == (200, "testrun")
    assert v["metrics"]["commits_total"]["value"] == 3.0
    assert set(v["phase_breakdown"]) == {"data", "h2d", "step", "commit"}
    code, text = _get(addr, "/trace")
    epochs = [e for e in json.loads(text)["traceEvents"] if e.get("name") == "epoch"]
    assert code == 200 and epochs[0]["args"]["run_id"] == "testrun"
    code, text = _get(addr, "/timeseries")
    assert (code, json.loads(text)) == (200, {"enabled": False, "samples": []})
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(addr, "/nope")
    assert err.value.code == 404 and "/metrics" in err.value.read().decode()
    disc = json.loads(open(tmp_path / f"flightdeck_{os.getpid()}.json").read())
    assert disc == {"address": addr, "pid": os.getpid(), "run_id": "testrun"}
    server_mod.stop()
    assert telemetry.flightdeck.address() is None


@pytest.mark.parametrize("mode", ["record", "strict"])
def test_healthz_reports_the_sanitizer_mode_and_violations(mode):
    """``/healthz`` carries the sanitizer's real mode and its recorded
    violations counted by kind, as the JAX package's exporter does."""
    from distkeras_tpu import sanitizer as jax_sanitizer
    from distkeras_tpu.telemetry.flightdeck import server as jax_server

    from distkeras_tpu_torch import sanitizer

    server_mod.configure(0)
    addr = server_mod.ensure_server()
    try:
        for san in (sanitizer, jax_sanitizer):
            san.configure("record")
            with pytest.warns(RuntimeWarning):
                san.report("transfer", "planted one")
                san.report("transfer", "planted two")
                san.report("lock", "planted three")
            if mode == "strict":
                san.configure("strict")  # a reconfigure clears the log
        health = json.loads(_get(addr, "/healthz")[1])
        want = {"record": {"transfer": 2, "lock": 1}, "strict": {}}[mode]
        assert health["sanitizer"] == {"mode": mode, "violations": want}
        assert health["sanitizer"] == json.loads(jax_server._render("/healthz")[1])["sanitizer"]
    finally:
        sanitizer.configure(None)
        jax_sanitizer.configure(None)


def test_ledger_endpoint_serves_the_ledger():
    from distkeras_tpu_torch.telemetry import accounting

    server_mod.configure(0)
    addr = server_mod.ensure_server()
    accounting.configure(True)
    try:
        accounting.ledger_for().admit("acme", prompt_tokens=4, queue_wait_s=0.0, device_s=0.1)
        code, text = _get(addr, "/ledger")
        payload = json.loads(text)
        assert code == 200 and payload["enabled"] is True
        assert [r["tenant"] for r in payload["tenants"]] == ["acme"]
        assert payload["tenants"][0]["decode_tokens"] == 1
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(addr, "/nope")
        assert "/ledger" in err.value.read().decode()
        accounting.configure(False)
        assert json.loads(_get(addr, "/ledger")[1]) == {"enabled": False, "tenants": []}
    finally:
        accounting.configure(None)
        accounting.reset()


def test_trace_endpoint_filters_one_request():
    server_mod.configure(0)
    addr = telemetry.flightdeck.ensure_server()
    with telemetry.trace.bind(trace_id="t1", request_id="r1"):
        with telemetry.trace.span("serving.http_request"):
            pass
    with telemetry.trace.span("serving.decode_step", requests=["r1", "r2"]):
        pass
    with telemetry.trace.span("other"):
        pass
    _, text = _get(addr, "/trace?request_id=r1")
    names = sorted(e["name"] for e in json.loads(text)["traceEvents"])
    assert names == ["serving.decode_step", "serving.http_request"]


def test_custom_endpoint_registry():
    server_mod.configure(0)
    addr = telemetry.flightdeck.ensure_server()
    telemetry.flightdeck.add_endpoint("/aggregate",
                                      lambda: ("application/json", json.dumps({"jobs": 0})))
    assert _get(addr, "/aggregate") == (200, json.dumps({"jobs": 0}))
    telemetry.flightdeck.set_var("reason", "unit")
    assert json.loads(_get(addr, "/vars")[1])["vars"] == {"reason": "unit"}


# ------------------------------------------------------------ blackbox dump

def test_blackbox_dump_contents(tmp_path):
    telemetry.dynamics.record(2, {"grad_norm": np.ones(3, np.float32)}, {"grad_norm": 1.5})
    telemetry.metrics.counter("commits_total").inc(4)
    with telemetry.trace.span("epoch", epoch=2):
        pass
    path = blackbox_dump("unit test", extra={"job_id": "j1"})
    assert os.path.basename(path) == f"blackbox_testrun_{os.getpid()}.json"
    assert os.path.dirname(path) == str(tmp_path)
    bb = json.load(open(path))
    assert (bb["reason"], bb["run_id"], bb["pid"]) == ("unit test", "testrun", os.getpid())
    assert bb["dynamics"]["epoch"] == 2
    assert bb["dynamics"]["summary"]["grad_norm"] == 1.5
    assert bb["metrics"]["commits_total"]["value"] == 4.0
    assert bb["config"]["DISTKERAS_TELEMETRY_DIR"] == str(tmp_path)
    assert bb["extra"] == {"job_id": "j1"}
    kinds = [e["kind"] for e in bb["ring"]]
    assert "span" in kinds and "metric" in kinds
    spans = [e for e in bb["ring"] if e["kind"] == "span"]
    assert spans[-1]["event"]["args"]["run_id"] == "testrun"
    assert telemetry.metrics.snapshot()["telemetry_blackbox_dumps_total"]["value"] == 1.0


def test_blackbox_dump_disabled_returns_none(tmp_path):
    telemetry.configure(False)
    assert blackbox_dump("nope") is None
    assert not [f for f in os.listdir(tmp_path) if f.startswith("blackbox_")]


def _toy(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d,)) > 0).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[y]


def _downpour(lr=0.1, num_epoch=3, workers=4):
    x, onehot = _toy()
    t = tdk.DOWNPOUR(MLP(features=(16,), num_classes=2, in_features=8),
                     loss="categorical_crossentropy",
                     worker_optimizer=("sgd", {"learning_rate": lr}), num_workers=workers,
                     batch_size=16, num_epoch=num_epoch, communication_window=2, seed=7,
                     device="cpu")
    t.train(tdk.from_numpy(x, onehot))
    return t


def test_watchdog_halt_dumps_blackbox(tmp_path):
    """A seeded watchdog halt leaves a blackbox file carrying the ring, the
    run_id, and the last dynamics summary."""
    telemetry.dynamics.configure(enabled=True, watchdog="halt")
    with pytest.raises(TrainingDiverged):
        _downpour(lr=1e38, num_epoch=4, workers=2)
    boxes = [f for f in os.listdir(tmp_path) if f.startswith("blackbox_")]
    assert boxes == [f"blackbox_testrun_{os.getpid()}.json"]
    bb = json.load(open(tmp_path / boxes[0]))
    assert bb["run_id"] == "testrun" and "TrainingDiverged" in bb["reason"]
    assert bb["dynamics"] is not None
    assert bb["watchdog"]["action"] == "halt"
    assert {"watchdog", "span"} <= {e["kind"] for e in bb["ring"]}


def test_exporter_answers_mid_fit_under_concurrent_scrapes():
    """With the exporter on an ephemeral port, 4 scrape threads hammer every
    endpoint while a trainer fits, and each endpoint answered 200 before
    the fit returned."""
    server_mod.configure(0)
    addr = telemetry.flightdeck.activate() and telemetry.flightdeck.address()
    paths = ["/metrics", "/healthz", "/vars", "/trace"]
    results = []
    stop = threading.Event()

    def hammer(offset):
        while not stop.is_set():
            path = paths[(offset + len(results)) % len(paths)]
            try:
                code, _ = _get(addr, path, timeout=5)
            except urllib.error.URLError:
                code = -1
            results.append((path, code, time.monotonic()))

    from distkeras_tpu_torch.parallel import WindowedEngine

    real = WindowedEngine.run_epoch

    def run_epoch(engine, *args, **kwargs):
        # the port's CPU fit is shorter than a scrape round under load: the
        # first epoch waits (bounded) until every endpoint has answered once
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                any(p == path and c == 200 for p, c, _ in list(results)) for path in paths):
            time.sleep(0.01)
        return real(engine, *args, **kwargs)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    try:
        WindowedEngine.run_epoch = run_epoch
        _downpour()
        done = time.monotonic()
    finally:
        WindowedEngine.run_epoch = real
        stop.set()
        for th in threads:
            th.join(timeout=10)
    for path in paths:
        assert 200 in [c for p, c, ts in results if p == path and ts < done], path


# ------------------------------------------------------------------ rollup

def test_rollup_ring_windowed_reads_match_jax():
    """The same registry history through both packages' rings gives the
    same rates, quantiles and breach fractions."""
    from distkeras_tpu.telemetry.flightdeck import rollup as jax_rollup
    from distkeras_tpu.telemetry.metrics import Registry as JaxRegistry

    out = []
    for mod, reg in ((rollup, Registry()), (jax_rollup, JaxRegistry())):
        ring = mod.RollupRing(registry=reg, interval=1.0, capacity=4, clock=lambda: 0.0)
        for t in range(6):
            reg.counter("req_total").inc(2 * t)
            reg.histogram("lat_seconds", buckets=(0.1, 0.5, 1.0)).observe(0.2 * t)
            reg.gauge("lag").set(float(t))
            ring.tick(now=float(t))
        out.append((len(ring), ring.window_rate("req_total", 3.0, now=5.0),
                    ring.window_quantile("lat_seconds", 0.5, 3.0, now=5.0),
                    ring.window_breach_fraction("lag", 2.5, 10.0, now=5.0),
                    mod.quantile_from_cumulative({"0.1": 1, "0.25": 3, "+Inf": 4}, 0.75)))
    assert out[0] == out[1]


# ----------------------------------------------------- /generate over HTTP

def test_install_http_endpoint_serves_greedy_tokens():
    """``/generate`` on the exporter: concurrent POSTs and a GET answer with
    ``greedy_generate``'s tokens, a malformed request is a 400, and the
    scrape carries the serving counters under the run_id label."""
    model = TransformerLM(vocab_size=23, dim=16, heads=2, num_layers=2, max_len=32)
    params, _ = tdk.models.TorchModel(model).init(torch.Generator().manual_seed(0), None)
    trained = TrainedModel(tdk.models.TorchModel(model), params, device="cpu")
    server_mod.configure(0)
    addr = telemetry.flightdeck.ensure_server()
    engine = ServingEngine(trained, num_slots=3, page_size=8, registry=None, device="cpu")
    try:
        assert install_http_endpoint(engine) == "/generate"
        with pytest.raises(NotImplementedError, match="item 18"):
            install_http_endpoint(engine, path="/logged", traffic_log=object())
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, 23, size=n).tolist() for n in (3, 5, 4)]
        replies = [None] * len(prompts)

        def call(i):
            status, text = _post(addr, "/generate", {"prompt": prompts[i], "max_new_tokens": 5})
            replies[i] = (status, json.loads(text))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for prompt, (status, body) in zip(prompts, replies):
            ref = greedy_generate(trained, np.asarray([prompt], np.int32), 5)[0, len(prompt):]
            assert status == 200 and body["tokens"] == ref.tolist()
            assert body["finish_reason"] == "length"
        status, text = _get(addr, "/generate?prompt=1,2,3&max_new_tokens=2")
        assert status == 200 and len(json.loads(text)["tokens"]) == 2
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(addr, "/generate?max_new_tokens=2")  # no prompt
        assert err.value.code == 400
    finally:
        engine.stop()
    status, text = _get(addr, "/metrics")
    assert status == 200 and "serving_ttft_seconds_bucket{" in text
    assert 'serving_tokens_total{run_id="testrun"}' in text
    spans = [e for e in telemetry.trace.export()["traceEvents"]
             if e["name"] == "serving.http_request"]
    # 3 POSTs and the GET; the 400 is answered before the span opens
    assert len(spans) == 4 and all(len(e["args"]["trace_id"]) == 32 for e in spans)
