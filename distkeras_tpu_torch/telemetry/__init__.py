"""``distkeras_tpu_torch.telemetry`` — spans, metrics, profiler hooks, training
dynamics and the flight deck: the port of :mod:`distkeras_tpu.telemetry`.

* :mod:`.trace` — ``trace.span("epoch")`` context managers exporting Chrome
  trace-event JSON (open in Perfetto);
* :mod:`.metrics` — the process-global registry of counters, gauges and
  histograms with Prometheus-text, JSONL and ScalarLogger exporters;
* :mod:`.profiler` — step-windowed ``torch.profiler`` capture via
  ``DISTKERAS_PROFILE=dir``;
* :mod:`.dynamics` — on-device training-health stats
  (``DISTKERAS_DYNAMICS``) and the divergence watchdog;
* :mod:`.flightdeck` — live HTTP scrape (``DISTKERAS_TELEMETRY_HTTP``),
  flight-recorder ring with crash blackbox dumps, and the fleet ``run_id``
  stamped into every trace event and scrape;
* :mod:`.accounting` — the per-tenant ledger the serving engine bills
  (``DISTKERAS_ACCOUNTING``, served at ``/ledger``), and :mod:`.slo`, the
  SLO engine over the rollup ring (served at ``/slo``).

Everything is gated on ``DISTKERAS_TELEMETRY`` (see :mod:`.runtime`): with
the flag unset and no ``torch.profiler`` recording, ``trace.span()`` returns
a shared no-op and instrumented code paths take their original branch — no
extra host syncs, no extra allocations.  While a profiler records, a span
opens a ``record_function`` annotation of its name whatever the flag says
(``trace.active()`` is the check a site makes), so that a capture of all
threads (:func:`.profiler.profile`) holds every thread's spans.
"""

from __future__ import annotations

import os

from distkeras_tpu_torch.telemetry import accounting, dynamics, flightdeck, runtime
from distkeras_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    merge_snapshots,
    metrics,
    prometheus_from_snapshot,
)
from distkeras_tpu_torch.telemetry.profiler import ProfilerHook
from distkeras_tpu_torch.telemetry.runtime import configure, enabled, out_dir
from distkeras_tpu_torch.telemetry.trace import Span, Tracer, trace

__all__ = ["Counter", "Gauge", "Histogram", "ProfilerHook", "Registry", "Span", "Tracer",
           "accounting", "configure", "dynamics", "enabled", "flightdeck", "flush", "merge_snapshots",
           "metrics", "out_dir", "prometheus_from_snapshot", "runtime", "trace"]


def flush(directory=None):
    """Write the trace and a metrics snapshot to ``directory`` (default:
    :func:`out_dir`).  Returns ``(trace_path, metrics_path)``, or ``None``
    when telemetry is disabled."""
    if not enabled():
        return None
    d = directory or out_dir()
    os.makedirs(d, exist_ok=True)
    pid = os.getpid()
    extra = {"pid": pid}
    rid = flightdeck.current_run_id()
    if rid is not None:
        extra["run_id"] = rid
    trace_path = trace.write(os.path.join(d, f"trace_{pid}.json"))
    metrics_path = metrics.write_jsonl(os.path.join(d, f"metrics_{pid}.jsonl"), extra=extra)
    return trace_path, metrics_path
