"""``distkeras_tpu_torch.telemetry`` — spans, gated on ``DISTKERAS_TELEMETRY``
as in the JAX package.  Metrics, profiler hooks, the flight deck and
accounting come with the telemetry slice."""

from distkeras_tpu_torch.telemetry import runtime
from distkeras_tpu_torch.telemetry.runtime import configure, enabled
from distkeras_tpu_torch.telemetry.trace import Span, Tracer, trace

__all__ = ["Span", "Tracer", "configure", "enabled", "runtime", "trace"]
