"""The port's trace API and profiler hook, against tests/test_telemetry.py:
span nesting and thread safety, Chrome-trace export and its golden file
(the JAX package's), the disabled path's cost, the phase histograms,
request-trace binding, ``flush``/``out_dir``, the step-windowed
``torch.profiler`` hook, and end-to-end trainer runs that must write a
Perfetto-loadable trace nested epoch -> window -> commit with the JAX
package's span names, and leave the trajectory bit for bit as it was.
(The registry's own cases are tests/test_torch_metrics.py's.)
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import distkeras_tpu_torch as tdk
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.models import MLP
from distkeras_tpu_torch.telemetry.profiler import ProfilerHook, kernel_times, profile
from distkeras_tpu_torch.telemetry.trace import NOOP_SPAN, Tracer, new_trace_id

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(autouse=True)
def clean_telemetry(tmp_path, monkeypatch):
    """Each test starts enabled with empty global tracer/registry and leaves
    the process env-driven again; any flush lands in tmp_path."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    telemetry.configure(True)
    telemetry.trace.reset()
    telemetry.metrics.reset()
    yield
    telemetry.trace.reset()
    telemetry.metrics.reset()
    telemetry.configure(None)


def fake_clock():
    """Deterministic clock: 0.0, 1.0, 2.0, ... — one tick per call."""
    t = {"v": -1.0}

    def clock():
        t["v"] += 1.0
        return t["v"]

    return clock


# ------------------------------------------------------------------- spans

def test_span_nesting_parent_chain_and_containment():
    tr = Tracer(clock=fake_clock(), pid=0)
    with tr.span("epoch", epoch=0):
        with tr.span("window"):
            with tr.span("commit"):
                pass
    evs = {e["name"]: e for e in tr.export()["traceEvents"]}
    assert evs["epoch"]["args"] == {"epoch": 0}
    assert evs["window"]["args"]["parent"] == "epoch"
    assert evs["commit"]["args"]["parent"] == "window"
    for child, parent in (("window", "epoch"), ("commit", "window")):
        c, p = evs[child], evs[parent]
        assert p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"]


def test_sibling_spans_share_parent_and_do_not_nest():
    tr = Tracer(clock=fake_clock(), pid=0)
    with tr.span("epoch"):
        with tr.span("a"):
            pass
        with tr.span("b"):
            pass
    evs = {e["name"]: e for e in tr.export()["traceEvents"]}
    assert evs["a"]["args"]["parent"] == evs["b"]["args"]["parent"] == "epoch"
    assert evs["a"]["ts"] + evs["a"]["dur"] <= evs["b"]["ts"]


def test_span_thread_safety():
    tr = Tracer()
    n_threads, n_spans = 8, 50
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait()
        for k in range(n_spans):
            with tr.span(f"outer_{i}", k=k):
                with tr.span(f"inner_{i}"):
                    pass

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = tr.export()["traceEvents"]
    assert len(evs) == n_threads * n_spans * 2
    assert len({e["tid"] for e in evs}) == n_threads
    assert all(e["dur"] >= 0 for e in evs)
    for e in evs:
        if e["name"].startswith("inner_"):
            assert e["args"]["parent"] == "outer_" + e["name"].split("_")[1]


def test_exported_trace_is_json_loadable(tmp_path):
    with telemetry.trace.span("epoch"):
        pass
    path = telemetry.trace.write(str(tmp_path / "trace.json"))
    payload = json.load(open(path))
    assert payload["traceEvents"][0]["name"] == "epoch"
    assert payload["traceEvents"][0]["ph"] == "X"


def test_chrome_trace_golden():
    """The JAX package's golden file, from the port's tracer."""
    tr = Tracer(clock=fake_clock(), pid=0)
    with tr.span("epoch", epoch=0):
        with tr.span("window", windows=2):
            with tr.span("step", phase=None):
                pass
            with tr.span("commit"):
                pass
    golden = json.load(open(os.path.join(GOLDEN, "telemetry_trace.json")))
    assert tr.export() == golden


def test_disabled_span_is_shared_noop_and_cheap():
    telemetry.configure(False)
    s1 = telemetry.trace.span("x")
    s2 = telemetry.trace.span("y", phase="step", attr=1)
    assert s1 is s2 is NOOP_SPAN
    with s1:
        pass
    telemetry.configure(True)
    assert telemetry.trace.export()["traceEvents"] == []
    telemetry.configure(False)
    n = 20000
    d = {"k": 1}
    t0 = time.perf_counter()
    for _ in range(n):
        d.get("k")
    dict_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        telemetry.trace.span("x")
    span_t = time.perf_counter() - t0
    assert span_t < max(100 * dict_t, 0.05), (
        f"disabled span() cost {span_t:.4f}s vs dict lookup {dict_t:.4f}s")


def test_phase_spans_feed_the_phase_histograms():
    assert telemetry.metrics.phase_breakdown() == {
        "data": 0.0, "h2d": 0.0, "step": 0.0, "commit": 0.0}
    with telemetry.trace.span("x", phase="step"):
        time.sleep(0.001)
    assert telemetry.metrics.phase_breakdown()["step"] > 0.0


def test_bind_stamps_the_request_context_and_nests():
    tr = Tracer(clock=fake_clock(), pid=0)
    tid = new_trace_id()
    assert len(tid) == 32 and tid != new_trace_id()
    with tr.bind(trace_id=tid, request_id="r1"):
        assert tr.context() == {"trace_id": tid, "request_id": "r1"}
        with tr.bind(request_id="r2", tenant="", shard=3):  # falsy values skipped
            assert tr.context() == {"trace_id": tid, "request_id": "r2", "shard": 3}
            with tr.span("inner", request_id="explicit"):
                pass
        with tr.span("outer"):
            pass
    assert tr.context() == {}
    evs = {e["name"]: e["args"] for e in tr.export()["traceEvents"]}
    assert evs["inner"] == {"request_id": "explicit", "trace_id": tid, "shard": 3}
    assert evs["outer"] == {"trace_id": tid, "request_id": "r1"}


def test_record_places_a_span_timed_elsewhere():
    tr = Tracer(clock=fake_clock(), pid=0)
    tr.record("queue_wait", 3.0, 5.0, request_id="q")
    (ev,) = tr.export()["traceEvents"]
    assert (ev["name"], ev["dur"], ev["args"]) == ("queue_wait", 2e6, {"request_id": "q"})


def test_flush_writes_trace_and_metrics(tmp_path, monkeypatch):
    from distkeras_tpu_torch.telemetry.flightdeck import correlate

    correlate.set_run_id("flushrun")
    try:
        with telemetry.trace.span("epoch"):
            pass
        telemetry.metrics.counter("c").inc()
        trace_path, metrics_path = telemetry.flush()
    finally:
        correlate.set_run_id(None)
    assert os.path.dirname(trace_path) == str(tmp_path)
    assert json.load(open(trace_path))["traceEvents"][0]["args"]["run_id"] == "flushrun"
    line = json.loads(open(metrics_path).read().splitlines()[-1])
    assert (line["pid"], line["run_id"]) == (os.getpid(), "flushrun")
    telemetry.configure(False)
    assert telemetry.flush() is None


def test_out_dir_priority(monkeypatch):
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", "/x/explicit")
    assert telemetry.out_dir() == "/x/explicit"
    monkeypatch.delenv("DISTKERAS_TELEMETRY_DIR")
    monkeypatch.setenv("DISTKERAS_TELEMETRY", "/x/valued")
    assert telemetry.out_dir() == "/x/valued"
    monkeypatch.setenv("DISTKERAS_TELEMETRY", "1")
    assert telemetry.out_dir() == "distkeras_telemetry"


# ---------------------------------------------------------------- profiler

def test_profiler_hook_windowing(monkeypatch):
    calls = []
    monkeypatch.setattr(ProfilerHook, "_start", lambda self: calls.append("start"))
    monkeypatch.setattr(ProfilerHook, "_stop", lambda self: calls.append("stop"))
    hook = ProfilerHook("/tmp/prof", start_step=1, stop_step=3)
    for step in range(5):
        hook.on_step(step)
    hook.close()
    assert calls == ["start", "stop"] and hook.done


def test_profiler_hook_close_stops_midwindow(monkeypatch):
    calls = []
    monkeypatch.setattr(ProfilerHook, "_start", lambda self: calls.append("start"))
    monkeypatch.setattr(ProfilerHook, "_stop", lambda self: calls.append("stop"))
    hook = ProfilerHook("/tmp/prof", start_step=0)
    hook.on_step(0)
    hook.close()
    assert calls == ["start", "stop"]


def test_profiler_from_env(monkeypatch, tmp_path):
    monkeypatch.delenv("DISTKERAS_PROFILE", raising=False)
    assert ProfilerHook.from_env() is None
    monkeypatch.setenv("DISTKERAS_PROFILE", str(tmp_path))
    monkeypatch.setenv("DISTKERAS_PROFILE_STEPS", "2:4")
    hook = ProfilerHook.from_env()
    assert (hook.logdir, hook.start_step, hook.stop_step) == (str(tmp_path), 2, 4)
    monkeypatch.setenv("DISTKERAS_PROFILE_STEPS", "x")
    with pytest.raises(ValueError, match="start:stop"):
        ProfilerHook.from_env()


def test_profile_writes_a_chrome_trace(tmp_path):
    with profile(str(tmp_path)) as out:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(out["path"]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert kernel_times(out["path"]) == {}  # no card, no device kernels


def _annotations(path, name):
    events = json.load(open(path))["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == name]


@pytest.mark.parametrize("on", [True, False])
def test_spans_annotate_a_recording_profiler(tmp_path, on):
    """While a torch profiler records, a span opens a ``record_function`` of
    its name, telemetry on (the tracer records it too) or off (it alone);
    outside one a span opens none."""
    telemetry.configure(on)
    assert telemetry.trace.active() is on
    with profile(str(tmp_path)) as out:
        assert telemetry.trace.active()
        with telemetry.trace.span("outer.span", attr=1):
            with telemetry.trace.span("inner.span", phase="step"):
                torch.ones(4) + 1
    with telemetry.trace.span("after.span"):
        pass
    outer, inner = _annotations(out["path"], "outer.span"), _annotations(out["path"], "inner.span")
    assert len(outer) == len(inner) == 1
    assert outer[0]["ts"] <= inner[0]["ts"] <= inner[0]["ts"] + inner[0]["dur"] <= (
        outer[0]["ts"] + outer[0]["dur"])
    telemetry.configure(True)
    recorded = [e["name"] for e in telemetry.trace.events()]
    assert recorded == (["inner.span", "outer.span", "after.span"] if on else [])


def test_profile_records_a_thread_started_before_it(tmp_path):
    """The port's profiler records every thread: spans of a thread already
    running when the capture starts are in it, on that thread's id."""
    telemetry.configure(False)
    stop, ident = threading.Event(), {}

    def loop():
        ident["tid"] = threading.get_native_id()
        while not stop.is_set():
            with telemetry.trace.span("loop.span"):
                torch.ones(8) + 1
            time.sleep(0.002)

    worker = threading.Thread(target=loop, daemon=True)
    worker.start()
    try:
        time.sleep(0.02)
        with profile(str(tmp_path)) as out:
            time.sleep(0.1)
    finally:
        stop.set()
        worker.join(timeout=10)
    assert not worker.is_alive()
    spans = _annotations(out["path"], "loop.span")
    assert spans and {e["tid"] for e in spans} == {ident["tid"]}


def test_env_profiler_captures_the_named_epochs(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTKERAS_PROFILE", str(tmp_path / "prof"))
    monkeypatch.setenv("DISTKERAS_PROFILE_STEPS", "1:2")
    _train(num_epoch=3)
    assert len(os.listdir(tmp_path / "prof")) == 1


# ------------------------------------------------------------- end to end

def _toy(n=256, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=(d,)) > 0).astype(np.int32)
    return x, np.eye(2, dtype=np.float32)[y]


def _train(num_epoch=2, **kwargs):
    x, onehot = _toy()
    t = tdk.DOWNPOUR(MLP(features=(16,), num_classes=2, in_features=8),
                     loss="categorical_crossentropy",
                     worker_optimizer=("sgd", {"learning_rate": 0.1}), num_workers=4,
                     batch_size=16, num_epoch=num_epoch, communication_window=4, seed=7,
                     device="cpu", **kwargs)
    t.train(tdk.from_numpy(x, onehot))
    return t


def test_trajectory_unchanged_by_telemetry():
    telemetry.configure(False)
    base = _train().get_history()["loss"]
    telemetry.configure(True)
    assert _train().get_history()["loss"] == base  # bit for bit


def test_smoke_train_writes_nested_chrome_trace(tmp_path):
    _train()
    traces = [f for f in os.listdir(tmp_path) if f.startswith("trace_")]
    assert len(traces) == 1
    events = json.load(open(tmp_path / traces[0]))["traceEvents"]
    parents = {e["name"]: e["args"].get("parent") for e in events}
    assert parents["window"] == "epoch" and parents["commit"] == "window"
    assert parents["step"] == "window"
    epochs = [e for e in events if e["name"] == "epoch"]
    assert [e["args"]["epoch"] for e in epochs] == [0, 1]
    w = min((e for e in events if e["name"] == "window"), key=lambda e: e["ts"])
    ep = epochs[0]
    assert ep["ts"] <= w["ts"] and w["ts"] + w["dur"] <= ep["ts"] + ep["dur"]
    metrics_files = [f for f in os.listdir(tmp_path) if f.startswith("metrics_")]
    snap = json.loads(open(tmp_path / metrics_files[0]).read().splitlines()[-1])
    assert {"phase_data_seconds", "phase_h2d_seconds", "phase_step_seconds",
            "phase_commit_seconds"} <= set(snap["metrics"])
    assert snap["metrics"]["training_seconds"]["value"] > 0
    assert snap["metrics"]["samples_per_sec_per_chip"]["value"] > 0


def test_streaming_train_records_spans():
    _train(num_epoch=1, streaming=True)
    names = {e["name"] for e in telemetry.trace.export()["traceEvents"]}
    assert {"epoch", "window_dispatch", "window_gather"} <= names


def test_run_epoch_sync_telemetry_off_records_no_span():
    from distkeras_tpu_torch import algorithms
    from distkeras_tpu_torch.data import epoch_arrays
    from distkeras_tpu_torch.models import TorchModel
    from distkeras_tpu_torch.parallel import WindowedEngine

    x, onehot = _toy()
    eng = WindowedEngine(TorchModel(MLP(features=(16,), num_classes=2, in_features=8)),
                         "categorical_crossentropy", "sgd", algorithms.Downpour(2), 2,
                         device="cpu")
    state = eng.init_state(torch.Generator().manual_seed(0), x[:16])
    sx, sy = eng.shard_batches(*epoch_arrays(x, onehot, 2, 16, 2))
    telemetry.trace.reset()
    state, _ = eng.run_epoch(state, sx, sy, sync_telemetry=False)
    assert telemetry.trace.export()["traceEvents"] == []
    eng.run_epoch(state, sx, sy)
    assert {e["name"] for e in telemetry.trace.export()["traceEvents"]} == {
        "window", "step", "commit"}
