"""The port's SLO engine and rollup ring, against tests/test_slo.py: every
case of the JAX file but the ``dkmon`` CLI's (``tools/``) and the window
scheduler's (ROADMAP Queue A item 18c), run on the port's
modules: rollup-ring windowing, the quantile and breach estimators, burn-rate
fire/resolve with the incident JSONL, the ``slo_*``/``alert_*`` schema
against the JAX package's golden text, the flag-off pin and the ``/slo``
view, served live through the port's flight deck and by the Punchcard
daemon's ``slo_status`` verb.  ``breach_fraction_from_
cumulative`` and an engine's burn rates equal the JAX package's on one
input.  No device."""

import json
import os
import urllib.request

import pytest
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.telemetry import slo
from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck import rollup
from distkeras_tpu_torch.telemetry.flightdeck import server as server_mod
from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder
from distkeras_tpu_torch.telemetry.metrics import (
    Registry,
    _merge_histograms,
    merge_snapshots,
)

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO_ROOT, "tests", "golden")


@pytest.fixture(autouse=True)
def clean_signal_plane(tmp_path, monkeypatch):
    """Telemetry on, rollups off (tests opt in per-case), fixed run_id,
    and every module-global env-driven again on the way out."""
    monkeypatch.setenv("DISTKERAS_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("DISTKERAS_SLO_INCIDENTS", raising=False)
    telemetry.configure(True)
    rollup.configure(False)
    telemetry.metrics.reset()
    recorder.reset()
    correlate.set_run_id("testrun")
    yield
    rollup.stop()
    rollup.configure(None)
    slo.reset_engines()
    telemetry.metrics.reset()
    recorder.reset()
    correlate.set_run_id(None)
    telemetry.configure(None)


def _hist(buckets, count=None, total=None):
    """Cumulative-bucket histogram payload in snapshot shape."""
    n = count if count is not None else max(buckets.values(), default=0)
    return {"type": "histogram", "sum": total or 0.0, "count": n,
            "buckets": dict(buckets)}


def _ring(interval=1.0, capacity=256):
    return rollup.RollupRing(registry=Registry(), interval=interval,
                             capacity=capacity, clock=lambda: 0.0)


# -------------------------------------------------- quantile estimation


def test_quantile_exact_on_bucket_boundaries():
    buckets = {"0.1": 4, "0.25": 8, "+Inf": 8}
    # rank q*total landing exactly on a cumulative count returns that
    # bucket's upper bound, not an interpolation
    assert rollup.quantile_from_cumulative(buckets, 0.5) == 0.1
    assert rollup.quantile_from_cumulative(buckets, 1.0) == 0.25
    # inside the (0.1, 0.25] bucket: linear from the previous bound
    assert rollup.quantile_from_cumulative(buckets, 0.75) == pytest.approx(
        0.175)
    # q=0 sits at the lower edge of the first populated bucket
    assert rollup.quantile_from_cumulative(buckets, 0.0) == 0.0


def test_quantile_overflow_clamps_to_top_finite_bound():
    buckets = {"0.1": 2, "+Inf": 4}
    # ranks in the +Inf overflow cannot be resolved past the ladder's top
    # rung; the clamp keeps the answer finite and threshold-comparable
    assert rollup.quantile_from_cumulative(buckets, 1.0) == 0.1


def test_quantile_skips_empty_buckets():
    buckets = {"0.05": 0, "0.1": 0, "0.25": 6, "+Inf": 6}
    assert rollup.quantile_from_cumulative(buckets, 0.0) == pytest.approx(0.1)
    assert rollup.quantile_from_cumulative(buckets, 1.0) == 0.25


def test_quantile_monotone_in_q_and_input_validation():
    buckets = {"0.01": 3, "0.1": 7, "0.5": 11, "2.5": 12, "+Inf": 13}
    grid = [rollup.quantile_from_cumulative(buckets, q / 20)
            for q in range(21)]
    assert grid == sorted(grid)
    assert rollup.quantile_from_cumulative({}, 0.5) == 0.0
    assert rollup.quantile_from_cumulative({"0.1": 0, "+Inf": 0}, 0.5) == 0.0
    with pytest.raises(ValueError):
        rollup.quantile_from_cumulative(buckets, 1.5)


def test_quantile_monotone_across_merge_of_different_ladders():
    """Carry-forward union of two ladders only ever moves cumulative counts
    up, so merged quantiles stay exact on shared boundaries and bracketed
    by the per-job answers elsewhere."""
    a = _hist({"0.1": 10, "+Inf": 10})          # all ten under 100ms
    b = _hist({"0.25": 10, "+Inf": 10})         # all ten under 250ms
    merged = _merge_histograms([a, b])
    assert merged["buckets"] == {"0.1": 10, "0.25": 20, "+Inf": 20}
    # p50 of the merge = a's contribution, boundary-exact
    assert rollup.quantile_from_cumulative(merged["buckets"], 0.5) == 0.1
    assert rollup.quantile_from_cumulative(merged["buckets"], 1.0) == 0.25
    lo = min(rollup.quantile_from_cumulative(a["buckets"], 0.9),
             rollup.quantile_from_cumulative(b["buckets"], 0.9))
    hi = max(rollup.quantile_from_cumulative(a["buckets"], 0.9),
             rollup.quantile_from_cumulative(b["buckets"], 0.9))
    got = rollup.quantile_from_cumulative(merged["buckets"], 0.9)
    assert lo <= got <= hi
    grid = [rollup.quantile_from_cumulative(merged["buckets"], q / 20)
            for q in range(21)]
    assert grid == sorted(grid)


def test_breach_fraction_boundary_exact_and_interpolated():
    buckets = {"0.1": 4, "0.25": 8, "+Inf": 8}
    # threshold on a boundary: exactly the observations beyond that bucket
    assert slo.breach_fraction_from_cumulative(buckets, 0.1) == 0.5
    assert slo.breach_fraction_from_cumulative(buckets, 0.25) == 0.0
    # inside a bucket: linear interpolation of the cumulative count
    assert slo.breach_fraction_from_cumulative(buckets, 0.175) == \
        pytest.approx(0.25)
    assert slo.breach_fraction_from_cumulative({}, 0.1) == 0.0


def test_breach_fraction_counts_overflow_conservatively():
    buckets = {"0.1": 2, "+Inf": 8}
    # 6 observations in +Inf breach any threshold above the top rung
    assert slo.breach_fraction_from_cumulative(buckets, 0.2) == 0.75


# ------------------------------------------------------- the rollup ring


def test_window_rate_spans_the_full_window():
    ring = _ring()
    c = ring.registry.counter("reqs_total", help="x")
    ring.tick(now=0.0)
    c.inc(50)
    ring.tick(now=10.0)
    c.inc(100)
    ring.tick(now=20.0)
    # the tick at-or-before the window start anchors the delta, so a 20s
    # window measures 20s of increase, not just the in-window ticks
    assert ring.window_rate("reqs_total", 20.0, now=20.0) == pytest.approx(7.5)
    assert ring.window_rate("reqs_total", 10.0, now=20.0) == pytest.approx(
        10.0)
    # counter reset (restart) clamps to zero instead of a negative rate
    ring.ingest(30.0, {"reqs_total": {"type": "counter", "value": 0}})
    assert ring.window_rate("reqs_total", 10.0, now=30.0) == 0.0
    # one usable tick is not a rate
    assert ring.window_rate("reqs_total", 5.0, now=100.0) is None


def test_window_quantile_from_bucket_deltas():
    ring = _ring()
    ring.ingest(0.0, {"lat": _hist({"0.1": 100, "0.25": 100, "+Inf": 100})})
    # between t=0 and t=10: 4 new obs <= 0.1, 4 more in (0.1, 0.25]
    ring.ingest(10.0, {"lat": _hist({"0.1": 104, "0.25": 108, "+Inf": 108})})
    delta = ring.window_delta("lat", 10.0, now=10.0)
    assert delta["count"] == 8
    assert delta["buckets"] == {"0.1": 4, "0.25": 8, "+Inf": 8}
    # history before the window never leaks in: the old 100 obs are gone
    assert ring.window_quantile("lat", 0.5, 10.0, now=10.0) == 0.1
    assert ring.window_quantile("lat", 1.0, 10.0, now=10.0) == 0.25
    # a quiet window (no new observations) is None, not 0-latency
    ring.ingest(20.0, {"lat": _hist({"0.1": 104, "0.25": 108, "+Inf": 108})})
    assert ring.window_quantile("lat", 10.0, 10.0, now=20.0) is None


def test_window_breach_fraction_both_ops():
    ring = _ring()
    for t, v in [(0.0, 0.0), (1.0, 0.0), (2.0, 5.0), (3.0, 5.0)]:
        ring.ingest(t, {"lag": {"type": "gauge", "value": v}})
    # the tick at exactly now-window anchors the window (inclusive start)
    assert ring.window_breach_fraction("lag", 2.0, 1.0, now=3.0) == 1.0
    assert ring.window_breach_fraction("lag", 2.0, 2.0, now=3.0) == \
        pytest.approx(2 / 3)
    assert ring.window_breach_fraction("lag", 2.0, 3.0, now=3.0) == 0.5
    # ticks after `now` never count (injected clocks, skewed job clocks)
    assert ring.window_breach_fraction("lag", 2.0, 1.0, now=1.0) == 0.0
    # op="lt": a healthy-replica count breaching *below* the floor
    assert ring.window_breach_fraction("lag", 2.0, 1.0, now=3.0,
                                       op="lt") == 0.0
    assert ring.window_breach_fraction("lag", 6.0, 1.0, now=3.0,
                                       op="lt") == 1.0
    assert ring.window_breach_fraction("nope", 1.0, 2.0, now=3.0) is None
    with pytest.raises(ValueError):
        ring.window_breach_fraction("lag", 1.0, 2.0, now=3.0, op="ge")


def test_ring_capacity_evicts_oldest():
    ring = rollup.RollupRing(registry=Registry(), interval=1.0, capacity=4,
                             clock=lambda: 0.0)
    for t in range(6):
        ring.ingest(float(t), {"g": {"type": "gauge", "value": float(t)}})
    assert len(ring) == 4
    assert [unix for unix, _ in ring.samples()] == [2.0, 3.0, 4.0, 5.0]
    assert [unix for unix, _ in ring.samples(since=4.0)] == [4.0, 5.0]


def test_export_filters_and_merge_series():
    ring = _ring()
    ring.ingest(10.0, {"a_total": {"type": "counter", "value": 1},
                       "g": {"type": "gauge", "value": 3.0}})
    out = ring.export(since=5.0, names=["a_total"])
    assert out["interval"] == 1.0
    assert [s["metrics"] for s in out["samples"]] == [
        {"a_total": {"type": "counter", "value": 1}}]
    # two jobs' rings merged onto one axis: same-bin counters sum, gauges
    # keep max + fleet mean — the same algebra as the /metrics fleet merge
    job_b = _ring()
    job_b.ingest(10.4, {"a_total": {"type": "counter", "value": 2},
                        "g": {"type": "gauge", "value": 5.0}})
    merged = rollup.merge_series([ring.export(), job_b.export()], align_s=1.0)
    assert len(merged["samples"]) == 1
    metrics = merged["samples"][0]["metrics"]
    assert metrics["a_total"] == {"type": "counter", "value": 3}
    assert metrics["g"]["value"] == 5.0 and metrics["g"]["mean"] == 4.0
    # distinct bins stay distinct — absence of a tick is itself a signal
    job_b.ingest(12.0, {"g": {"type": "gauge", "value": 1.0}})
    merged = rollup.merge_series([ring.export(), job_b.export()], align_s=1.0)
    assert [s["unix"] for s in merged["samples"]] == [10.0, 12.0]


def test_ring_tick_reuses_registry_snapshot_shapes():
    ring = _ring()
    ring.registry.counter("ticks_total", help="x").inc(3)
    ring.registry.histogram("lat_seconds", help="x").observe(0.07)
    ring.tick(now=1.0)
    (_, snap), = ring.samples()
    assert snap["ticks_total"] == {"type": "counter", "value": 3}
    assert snap["lat_seconds"]["count"] == 1
    # snapshots merge with the registry's own fleet algebra
    merged = merge_snapshots([snap, snap])
    assert merged["ticks_total"]["value"] == 6


# --------------------------------------------- burn-rate fire and resolve


def _breach_trace():
    """A ring with one gauge: healthy (0) for t<20, breaching (9) for
    t in [20, 27], recovered from t=28 — one tick per second."""
    ring = _ring()
    for t in range(41):
        v = 9.0 if 20 <= t <= 27 else 0.0
        ring.ingest(float(t), {"lag_seconds": {"type": "gauge", "value": v}})
    return ring


def _lag_objective(**kw):
    defaults = dict(name="lag", kind="gauge", metric="lag_seconds",
                    threshold=1.0, op="gt", target=0.9, fast_window_s=4.0,
                    slow_window_s=16.0, burn_threshold=2.0)
    defaults.update(kw)
    return slo.SLOConfig(**defaults)


def test_fast_window_breach_alone_does_not_fire(tmp_path):
    engine = slo.SLOEngine([_lag_objective()], source="t", ring=_breach_trace(),
                           registry=Registry(), clock=lambda: 22.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    status = engine.evaluate()
    row, = status["objectives"]
    # fast window (t 18..22): 3/5 bad -> burn 6; slow (t 6..22): 3/17 -> 1.76
    assert row["burn_fast"] == pytest.approx(6.0)
    assert row["burn_slow"] == pytest.approx((3 / 17) / 0.1)
    assert row["burn_slow"] < 2.0
    assert not row["firing"] and row["since"] is None
    assert not os.path.exists(tmp_path / "inc.jsonl")


def test_fire_then_resolve_writes_incident_pair(tmp_path):
    path = tmp_path / "inc.jsonl"
    now = {"t": 27.0}
    engine = slo.SLOEngine([_lag_objective()], source="t",
                           ring=_breach_trace(), registry=Registry(),
                           clock=lambda: now["t"], incident_file=str(path))
    row, = engine.evaluate()["objectives"]
    # both windows over threshold at t=27: fast 5/5 -> 10, slow 8/17 -> 4.7
    assert row["burn_fast"] == pytest.approx(10.0)
    assert row["burn_slow"] == pytest.approx((8 / 17) / 0.1)
    assert row["firing"] and row["since"] == 27.0
    # steady state: still firing, but no duplicate incident line
    engine.evaluate()
    # recovery at t=33: fast window clean resolves even while the slow
    # window still carries the breach
    now["t"] = 33.0
    row, = engine.evaluate()["objectives"]
    assert row["burn_fast"] == 0.0
    assert row["burn_slow"] >= 2.0
    assert not row["firing"] and row["since"] is None

    records = [json.loads(line) for line in open(path)]
    assert [r["event"] for r in records] == ["fire", "resolve"]
    fire = records[0]
    assert fire["objective"] == "lag" and fire["source"] == "t"
    assert fire["run_id"] == "testrun"
    assert fire["unix"] == 27.0
    assert fire["burn_fast"] == pytest.approx(10.0)
    assert fire["burn_threshold"] == 2.0
    assert isinstance(fire["trace_ids"], list)


def test_no_data_is_distinct_from_healthy(tmp_path):
    engine = slo.SLOEngine([_lag_objective(metric="never_seen")], source="t",
                           ring=_ring(), registry=Registry(),
                           clock=lambda: 10.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    row, = engine.evaluate()["objectives"]
    assert row["burn_fast"] is None and row["burn_slow"] is None
    assert not row["firing"]


def test_ratio_objective_burns_on_shed_rate(tmp_path):
    ring = _ring()
    routed = sheds = 0
    for t in range(31):
        routed += 10
        if t > 10:
            sheds += 5  # one third of traffic shed from t=11 on
        ring.ingest(float(t), {
            "routed_total": {"type": "counter", "value": routed},
            "sheds_total": {"type": "counter", "value": sheds},
        })
    obj = slo.SLOConfig(
        name="shed", kind="ratio", bad_metric="sheds_total",
        total_metric=("routed_total", "sheds_total"), target=0.99,
        fast_window_s=5.0, slow_window_s=20.0, burn_threshold=2.0)
    engine = slo.SLOEngine([obj], source="t", ring=ring, registry=Registry(),
                           clock=lambda: 30.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    row, = engine.evaluate()["objectives"]
    assert row["bad_fast"] == pytest.approx(1 / 3)
    assert row["burn_fast"] == pytest.approx((1 / 3) / 0.01)
    assert row["firing"]


def test_quantile_objective_reads_window_deltas(tmp_path):
    ring = _ring()
    ring.ingest(0.0, {"lat_seconds": _hist({"0.1": 50, "0.25": 50,
                                            "+Inf": 50})})
    # all 20 in-window observations land in (0.1, 0.25]: p99 ~ 0.25
    ring.ingest(8.0, {"lat_seconds": _hist({"0.1": 50, "0.25": 70,
                                            "+Inf": 70})})
    obj = slo.SLOConfig(name="p99", kind="quantile", metric="lat_seconds",
                        quantile=0.99, threshold=0.1, target=0.9,
                        fast_window_s=10.0, slow_window_s=40.0,
                        burn_threshold=2.0)
    engine = slo.SLOEngine([obj], source="t", ring=ring, registry=Registry(),
                           clock=lambda: 10.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    row, = engine.evaluate()["objectives"]
    assert row["bad_fast"] == 1.0  # every observation above the threshold
    assert row["burn_fast"] == pytest.approx(10.0)
    assert row["observed"] == pytest.approx(0.2485)


# ----------------------------------------------------- schema and wiring


def test_slo_metrics_schema_golden():
    registry = Registry()
    m = slo.slo_metrics(registry)
    m["objectives"].set(5)
    m["evaluations"].inc(12)
    m["burning"].set(1)
    m["burn_max"].set(10.5)
    m["firing"].set(1)
    m["fired"].inc(2)
    m["resolved"].inc(1)
    m["incidents"].inc(3)
    golden = open(os.path.join(GOLDEN, "slo_metrics.txt")).read()
    assert registry.to_prometheus(labels={"run_id": "fleet1234"}) == golden
    # get-or-create: a second call hands back the same instruments
    assert slo.slo_metrics(registry)["fired"] is m["fired"]


def test_engine_drives_canonical_instruments(tmp_path):
    registry = Registry()
    engine = slo.SLOEngine([_lag_objective()], source="t",
                           ring=_breach_trace(), registry=registry,
                           clock=lambda: 27.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    slo._ENGINES["t"] = engine  # fleet gauges read the registered set
    try:
        engine.evaluate()
        snap = registry.snapshot()
        assert snap["slo_evaluations_total"]["value"] == 1
        assert snap["slo_objectives"]["value"] == 1
        assert snap["slo_burning"]["value"] == 1
        assert snap["slo_burn_rate_max"]["value"] == pytest.approx(10.0)
        assert snap["alert_firing"]["value"] == 1
        assert snap["alert_fired_total"]["value"] == 1
        assert snap["alert_incidents_total"]["value"] == 1
    finally:
        slo.reset_engines()


def test_incident_path_honors_env_and_run_id(monkeypatch):
    assert slo.incident_path().endswith("incidents_testrun.jsonl")
    monkeypatch.setenv("DISTKERAS_SLO_INCIDENTS", "/tmp/custom.jsonl")
    assert slo.incident_path() == "/tmp/custom.jsonl"


def test_slo_config_validation():
    with pytest.raises(ValueError):
        slo.SLOConfig(name="x", kind="nope")
    with pytest.raises(ValueError):
        slo.SLOConfig(name="x", kind="gauge")  # needs a metric
    with pytest.raises(ValueError):
        slo.SLOConfig(name="x", kind="ratio", bad_metric="b")  # needs totals
    with pytest.raises(ValueError):
        slo.SLOConfig(name="x", kind="gauge", metric="m", target=1.0)
    with pytest.raises(ValueError):
        slo.SLOConfig(name="x", kind="gauge", metric="m",
                      fast_window_s=60.0, slow_window_s=30.0)
    with pytest.raises(ValueError):
        slo.SLOEngine([_lag_objective(), _lag_objective()])
    cfg = slo.SLOConfig(name="x", kind="gauge", metric="m", target=0.9)
    assert cfg.budget == pytest.approx(0.1)


def test_default_objectives_cover_shipped_metrics():
    serving = slo.default_serving_objectives()
    assert [o.name for o in serving] == [
        "serving_ttft_p99", "serving_tier_latency_p99",
        "serving_tier_replicas_available", "serving_tier_shed_ratio"]
    by_name = {o.name: o for o in serving}
    assert by_name["serving_tier_replicas_available"].op == "lt"
    online, = slo.default_online_objectives(30.0)
    assert online.metric == "online_window_lag_seconds"
    assert online.threshold == 60.0


# ------------------------------------------------------- the flag-off pin


def test_rollup_flag_off_is_inert():
    # fixture set rollup.configure(False): telemetry on, rollups off
    assert rollup.interval() is None
    assert rollup.ensure_rollup() is None
    assert rollup.rollup_ring() is None
    assert slo.maybe_engine([_lag_objective()], source="t") is None
    ctype, body, code = rollup.timeseries_view({"query": ""})
    assert code == 200
    assert json.loads(body) == {"enabled": False, "samples": []}


def test_telemetry_off_wins_over_rollup_env(monkeypatch):
    telemetry.configure(False)
    rollup.configure(1.0)
    assert rollup.ensure_rollup() is None
    assert slo.maybe_engine([_lag_objective()], source="t") is None


def test_rollup_env_parsing(monkeypatch):
    rollup.configure(None)
    monkeypatch.setenv("DISTKERAS_ROLLUP", "2.5")
    assert rollup.interval() == 2.5
    rollup.configure(None)
    monkeypatch.setenv("DISTKERAS_ROLLUP", "off")
    assert rollup.interval() is None
    rollup.configure(False)  # leave it off for the fixture teardown


def test_ensure_rollup_starts_one_shared_ring():
    rollup.configure(0.05)
    ring = rollup.ensure_rollup()
    try:
        assert ring is not None
        assert rollup.ensure_rollup() is ring  # idempotent
        assert rollup.rollup_ring() is ring
        engine = slo.maybe_engine([_lag_objective()], source="t")
        assert engine is not None and engine.ring is ring
        assert slo.engines()["t"] is engine
    finally:
        rollup.stop()
        slo.reset_engines()
        rollup.configure(False)
    assert rollup.rollup_ring() is None


def test_slo_view_serves_registered_engines(tmp_path):
    engine = slo.SLOEngine([_lag_objective()], source="t",
                           ring=_breach_trace(), registry=Registry(),
                           clock=lambda: 27.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    slo._ENGINES["t"] = engine
    try:
        engine.evaluate()
        ctype, body, code = slo.slo_view()
        assert (ctype, code) == ("application/json", 200)
        payload = json.loads(body)
        assert payload["enabled"] and payload["run_id"] == "testrun"
        row, = payload["engines"]["t"]["objectives"]
        assert row["name"] == "lag" and row["firing"]
    finally:
        slo.reset_engines()


# ------------------------------------------------------ against the JAX package


def test_breach_fraction_and_burn_rates_equal_jax(tmp_path):
    from distkeras_tpu.telemetry import slo as jax_slo
    from distkeras_tpu.telemetry.flightdeck import rollup as jax_rollup
    from distkeras_tpu.telemetry.metrics import Registry as JaxRegistry

    buckets = {"0.005": 3, "0.025": 9, "0.1": 20, "0.5": 31, "2.5": 33, "+Inf": 36}
    for threshold in (0.001, 0.005, 0.01, 0.1, 0.3, 2.5, 5.0):
        assert slo.breach_fraction_from_cumulative(buckets, threshold) == \
            jax_slo.breach_fraction_from_cumulative(buckets, threshold)
    rows = []
    for mod, ring_mod, reg in ((slo, rollup, Registry()),
                               (jax_slo, jax_rollup, JaxRegistry())):
        ring = ring_mod.RollupRing(registry=reg, interval=1.0, capacity=256,
                                   clock=lambda: 0.0)
        routed = sheds = 0
        for t in range(41):
            routed += 10
            sheds += 3 if 15 <= t <= 30 else 0
            v = 9.0 if 20 <= t <= 27 else 0.0
            cum = {"0.1": 4 * t, "0.25": 6 * t + (t > 22) * 3 * t, "+Inf": 7 * t + 3 * t}
            ring.ingest(float(t), {
                "lag_seconds": {"type": "gauge", "value": v},
                "routed_total": {"type": "counter", "value": routed},
                "sheds_total": {"type": "counter", "value": sheds},
                "lat_seconds": {"type": "histogram", "sum": 0.0, "count": cum["+Inf"],
                                "buckets": {k: float(n) for k, n in cum.items()}},
            })
        objectives = [
            mod.SLOConfig(name="lag", kind="gauge", metric="lag_seconds", threshold=1.0,
                          target=0.9, fast_window_s=4.0, slow_window_s=16.0),
            mod.SLOConfig(name="shed", kind="ratio", bad_metric="sheds_total",
                          total_metric=("routed_total", "sheds_total"), target=0.99,
                          fast_window_s=5.0, slow_window_s=20.0),
            mod.SLOConfig(name="p99", kind="quantile", metric="lat_seconds",
                          threshold=0.1, target=0.9, fast_window_s=10.0,
                          slow_window_s=40.0),
        ]
        engine = mod.SLOEngine(objectives, source="t", ring=ring, registry=reg,
                               clock=lambda: 27.0,
                               incident_file=str(tmp_path / f"{mod.__name__}.jsonl"))
        rows.append([{k: r[k] for k in ("bad_fast", "bad_slow", "burn_fast", "burn_slow",
                                        "observed", "firing")}
                     for r in engine.evaluate()["objectives"]])
    assert rows[0] == rows[1]
    assert any(r["firing"] for r in rows[0])


def test_slo_endpoint_serves_through_the_flight_deck(tmp_path):
    """``maybe_engine`` installs ``/slo`` on the port's exporter, which
    serves the registered engines' last evaluation."""
    rollup.configure(0.05)
    server_mod.configure(0)
    try:
        engine = slo.maybe_engine(slo.default_serving_objectives(), source="serving",
                                  incident_file=str(tmp_path / "inc.jsonl"))
        assert engine is not None and engine.ring is rollup.rollup_ring()
        engine.evaluate()
        addr = server_mod.ensure_server()
        with urllib.request.urlopen(f"http://{addr}/slo", timeout=10) as r:
            payload = json.loads(r.read().decode("utf-8"))
        assert payload["enabled"] and payload["run_id"] == "testrun"
        names = [row["name"] for row in payload["engines"]["serving"]["objectives"]]
        assert names == [o.name for o in slo.default_serving_objectives()]
    finally:
        server_mod.stop()
        server_mod.configure(None)
        rollup.stop()
        slo.reset_engines()
        rollup.configure(False)


def test_daemon_slo_status_verb_carries_local_engines(tmp_path):
    from distkeras_tpu_torch.job_deployment import Job, PunchcardServer

    engine = slo.SLOEngine([_lag_objective()], source="tier", ring=_breach_trace(),
                           registry=Registry(), clock=lambda: 27.0,
                           incident_file=str(tmp_path / "inc.jsonl"))
    slo._ENGINES["tier"] = engine
    engine.evaluate()
    server = PunchcardServer(port=0, secret="s3cret")
    server.start()
    try:
        reply = Job("127.0.0.1", server.port, secret="s3cret").slo_status()
        assert reply["status"] == "ok" and reply["firing_count"] == 1
        row, = reply["engines"]["daemon:tier"]["objectives"]
        assert row["name"] == "lag" and row["firing"]
        assert reply["firing"][0]["owner"] == "daemon"
        assert reply["timeseries"]["samples"] == []
    finally:
        server.stop()
        slo.reset_engines()
