"""``distkeras_tpu_torch.telemetry`` — spans, gated on ``DISTKERAS_TELEMETRY``
as in the JAX package, and the metrics registry (``telemetry.metrics`` is
the process-global :class:`~distkeras_tpu_torch.telemetry.metrics.Registry`,
as there).  Profiler hooks, the flight deck and accounting come with the
telemetry slice."""

from distkeras_tpu_torch.telemetry import runtime
from distkeras_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    merge_snapshots,
    metrics,
    prometheus_from_snapshot,
)
from distkeras_tpu_torch.telemetry.runtime import configure, enabled
from distkeras_tpu_torch.telemetry.trace import Span, Tracer, trace

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "Span", "Tracer", "configure",
           "enabled", "merge_snapshots", "metrics", "prometheus_from_snapshot", "runtime",
           "trace"]
