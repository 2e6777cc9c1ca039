"""``distkeras_tpu_torch.telemetry.flightdeck`` — live scrape, crash forensics,
fleet correlation: the port of :mod:`distkeras_tpu.telemetry.flightdeck`.

Three cooperating pieces on top of the flush-at-exit telemetry stack:

* :mod:`.server` — an HTTP exporter (``/metrics`` ``/healthz`` ``/vars``
  ``/trace``) on a daemon thread, gated by ``DISTKERAS_TELEMETRY_HTTP``;
* :mod:`.recorder` — a bounded flight-recorder ring of recent spans, metric
  deltas, watchdog observations, and sanitizer events, dumped as
  ``blackbox_<run_id>_<pid>.json`` at crash boundaries;
* :mod:`.correlate` — the fleet ``run_id`` stamped into every trace event
  and scrape so ``tools.dktrace merge`` can join per-process timelines.

This module imports only the correlate/recorder pieces eagerly (stdlib,
cycle-free); the HTTP server loads lazily on first use so the common
no-exporter path never pays for ``http.server``.
"""

from __future__ import annotations

from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck.correlate import run_id, set_run_id
from distkeras_tpu_torch.telemetry.flightdeck.correlate import current as current_run_id
from distkeras_tpu_torch.telemetry.flightdeck.recorder import (
    FlightRecorder,
    blackbox_dump,
    on_crash,
    recorder,
)

__all__ = [
    "FlightRecorder",
    "activate",
    "add_endpoint",
    "address",
    "blackbox_dump",
    "current_run_id",
    "ensure_rollup",
    "ensure_server",
    "http_port",
    "on_crash",
    "recorder",
    "rollup_ring",
    "run_id",
    "set_run_id",
    "set_var",
    "stop_server",
]


def activate():
    """The one call entry points make: mint/propagate the fleet ``run_id``,
    start the HTTP exporter when one is configured, and start the rollup
    ring when ``DISTKERAS_ROLLUP`` asks for one.  Returns the run id.
    """
    rid = run_id()
    ensure_server()
    ensure_rollup()
    return rid


# Thin lazy delegates — see module docstring.

def ensure_server():
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.ensure_server()


def address():
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.address()


def stop_server():
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.stop()


def http_port():
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.http_port()


def add_endpoint(path, fn):
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.add_endpoint(path, fn)


def set_var(name, value):
    from distkeras_tpu_torch.telemetry.flightdeck import server

    return server.set_var(name, value)


def ensure_rollup():
    from distkeras_tpu_torch.telemetry.flightdeck import rollup

    return rollup.ensure_rollup()


def rollup_ring():
    from distkeras_tpu_torch.telemetry.flightdeck import rollup

    return rollup.rollup_ring()
