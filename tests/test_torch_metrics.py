"""Port parity: the port's copied metrics registry
(``distkeras_tpu_torch.telemetry.metrics``) against the JAX package's
``distkeras_tpu.telemetry.metrics`` on the same operations — snapshots,
Prometheus text (with and without labels), fleet merges and their
exposition, the JSONL line and the phase breakdown are equal."""

import importlib
import json

import pytest
import torch

from distkeras_tpu_torch import telemetry as port_telemetry

# the modules themselves: each package's ``telemetry.metrics`` attribute is
# its global registry
jax_metrics = importlib.import_module("distkeras_tpu.telemetry.metrics")
port_metrics = importlib.import_module("distkeras_tpu_torch.telemetry.metrics")

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _drive(module, seed):
    """The same instrument operations on a fresh registry of ``module``."""
    reg = module.Registry()
    reg.counter("requests_total", help="requests served").inc()
    reg.counter("requests_total").inc(2.5 + seed)
    reg.gauge("queue_depth", help="waiting").set(3 + seed)
    reg.gauge("queue_depth").set(1.25)
    h = reg.histogram("phase_step_seconds", help="step wall time")
    for v in (0.00005, 0.0003, 0.004 * (seed + 1), 0.2, 7.0, 100.0):
        h.observe(v)
    reg.histogram("phase_data_seconds", buckets=(0.5, 0.1, 1.0)).observe(0.3)
    reg.counter("no_help_total")
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_and_prometheus_match_jax(seed):
    port, ref = _drive(port_metrics, seed), _drive(jax_metrics, seed)
    assert port.snapshot() == ref.snapshot()
    assert port.to_prometheus() == ref.to_prometheus()
    labels = {"run_id": "abc", "host": "h1"}
    assert port.to_prometheus(labels=labels) == ref.to_prometheus(labels=labels)
    assert port.phase_breakdown() == ref.phase_breakdown()


def test_merge_and_fleet_exposition_match_jax():
    snaps = {m: [_drive(m, s).snapshot() for s in (0, 1)] for m in (port_metrics, jax_metrics)}
    # a second job with a coarser ladder: merge carries counts forward
    for m in snaps:
        reg = m.Registry()
        reg.histogram("phase_step_seconds", buckets=(0.01, 1.0)).observe(0.5)
        snaps[m].append(reg.snapshot())
    port = port_metrics.merge_snapshots(snaps[port_metrics])
    ref = jax_metrics.merge_snapshots(snaps[jax_metrics])
    assert port == ref
    help_map = {"requests_total": "requests served"}
    assert (port_metrics.prometheus_from_snapshot(port, help_map, {"run_id": "r"})
            == jax_metrics.prometheus_from_snapshot(ref, help_map, {"run_id": "r"}))


def test_jsonl_and_scalar_bridge_match_jax(tmp_path):
    port, ref = _drive(port_metrics, 0), _drive(jax_metrics, 0)
    port.write_jsonl(tmp_path / "port.jsonl", extra={"step": 3})
    ref.write_jsonl(tmp_path / "ref.jsonl", extra={"step": 3})
    assert (json.loads((tmp_path / "port.jsonl").read_text())
            == json.loads((tmp_path / "ref.jsonl").read_text()))

    class Logger:
        def __init__(self):
            self.calls = []

        def log(self, step, **scalars):
            self.calls.append((step, scalars))

    a, b = Logger(), Logger()
    port.to_scalar_logger(a, 7)
    ref.to_scalar_logger(b, 7)
    assert a.calls == b.calls


def test_errors_match_jax():
    for m in (port_metrics, jax_metrics):
        reg = m.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered as Counter"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="counters only go up"):
            reg.counter("x").inc(-1)
        with pytest.raises(ValueError, match="at least one finite bucket"):
            m.Histogram("h", buckets=())
        with pytest.raises(ValueError, match="conflicting types"):
            m.merge_snapshots([{"a": {"type": "counter", "value": 1.0}},
                               {"a": {"type": "gauge", "value": 1.0}}])
    assert port_metrics.DEFAULT_BUCKETS == jax_metrics.DEFAULT_BUCKETS
    assert port_metrics.PHASES == jax_metrics.PHASES


def test_global_registry_and_reset():
    assert port_telemetry.metrics is port_metrics.metrics
    name = "test_torch_metrics_probe_total"
    port_telemetry.metrics.counter(name).inc()
    assert port_telemetry.metrics.snapshot()[name]["value"] >= 1.0
    fresh = port_metrics.Registry()
    fresh.counter(name).inc()
    fresh.reset()
    assert fresh.snapshot() == {} and fresh.to_prometheus() == ""
