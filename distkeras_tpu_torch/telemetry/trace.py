"""Span tracer exporting Chrome trace-event JSON (Perfetto-loadable).

The port of :mod:`distkeras_tpu.telemetry.trace` (host code, copied).
Usage at a host boundary (never inside a captured window):

    with telemetry.trace.span("epoch", epoch=3):
        with telemetry.trace.span("window", phase="step"):
            ...

Spans clock with ``time.perf_counter`` (monotonic — DK106's whole point),
nest per-thread, and are recorded as complete ("ph": "X") events whose
ts/dur containment gives Perfetto the nesting; each event also carries an
explicit ``args.parent`` so tests and scripts need no interval math.

When telemetry is disabled, ``span()`` returns a shared no-op context
manager — the cost is one cached-bool check and one dict-free branch, which
the test suite pins against plain dict-lookup cost.

A span opened with ``phase="step"`` (or data/h2d/commit/...) additionally
feeds the ``phase_<name>_seconds`` histogram in the global metrics registry
on exit — that is where the phase breakdown comes from.

Exceptions raised while recording are NOT swallowed, so instrumentation
bugs fail the run instead of silently disabling observability.

**Request tracing.**  A serving request crosses threads and processes
(router dispatch thread → replica HTTP handler → engine loop), so thread
nesting alone cannot stitch its spans together.  :meth:`Tracer.bind` binds a
``trace_id``/``request_id`` context to the current thread; every span the
thread records while bound carries those ids in its args (explicit span
attrs win).  Threads that do work *for* a request without a bound context —
the engine loop serves many requests per decode step — stamp the ids as
explicit span args instead.  ``tools/dktrace critical-path`` joins on them.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid

from distkeras_tpu_torch.telemetry import runtime
from distkeras_tpu_torch.telemetry.flightdeck import correlate as _correlate
from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder as _flight_recorder
from distkeras_tpu_torch.telemetry.metrics import metrics as _registry

__all__ = ["NOOP_SPAN", "Span", "Tracer", "new_trace_id", "trace"]


def new_trace_id() -> str:
    """A fresh 32-hex trace id (the distributed-trace correlation key —
    minted once at the first hop that sees the request, reused by every
    later hop)."""
    return uuid.uuid4().hex


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class _ContextBinding:
    """Context manager installing a trace context on the current thread;
    restores the previous binding on exit (bindings nest — an inner bind
    layers over, and restores, the outer one)."""

    __slots__ = ("_tracer", "_ctx", "_prev")

    def __init__(self, tracer, ctx):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self):
        tls = self._tracer._tls
        self._prev = getattr(tls, "ctx", None)
        tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, exc_type, exc, tb):
        self._tracer._tls.ctx = self._prev
        return False


class Span:
    """Context manager recording one complete trace event on exit."""

    __slots__ = ("_tracer", "name", "phase", "attrs", "_t0")

    def __init__(self, tracer, name, phase, attrs):
        self._tracer = tracer
        self.name = name
        self.phase = phase
        self.attrs = attrs

    def __enter__(self):
        self._tracer._push(self.name)
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self._tracer._clock()
        parent = self._tracer._pop()
        self._tracer._record(self.name, self._t0, t1, parent, self.attrs)
        if self.phase is not None:
            _registry.histogram(
                f"phase_{self.phase}_seconds",
                help=f"host-visible seconds in the {self.phase} phase",
            ).observe(t1 - self._t0)
        return False


class Tracer:
    """Thread-safe span recorder with Chrome trace-event export.

    ``clock`` and ``pid`` are injectable so golden-file tests are
    deterministic; production code uses the module-global :data:`trace`.

    Only a ``correlated`` tracer stamps the fleet ``run_id`` into event args
    and feeds finished spans to the flight-recorder ring — the module-global
    :data:`trace` is; ad-hoc tracers (golden tests, scripts) default to
    uncorrelated so their output is a pure function of their inputs.
    """

    def __init__(self, clock=time.perf_counter, pid=None, correlated=False):
        self._clock = clock
        self._pid = pid
        self._correlated = correlated
        self._lock = threading.Lock()
        self._events = []
        self._tls = threading.local()
        self._tids = {}
        self._origin = clock()

    # ------------------------------------------------------------- recording

    def span(self, name, phase=None, **attrs):
        if not runtime.enabled():
            return NOOP_SPAN
        return Span(self, name, phase, attrs)

    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _push(self, name):
        self._stack().append(name)

    def _pop(self):
        stack = self._stack()
        stack.pop()
        return stack[-1] if stack else None

    def current(self):
        """Name of this thread's innermost open span, or ``None``."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    # ------------------------------------------------------- trace context

    def bind(self, trace_id=None, request_id=None, **extra):
        """Bind a trace context to the current thread for the duration of a
        ``with`` block.  Every span recorded by this thread while bound
        carries the bound ids in its event args (explicit span attrs win
        over the context).  Falsy values are skipped, so
        ``bind(trace_id=req.trace_id)`` is safe when the id may be empty.

        Works whether or not telemetry is enabled — binding is a couple of
        thread-local writes; it is the spans that no-op when disabled."""
        ctx = dict(getattr(self._tls, "ctx", None) or {})
        if trace_id:
            ctx["trace_id"] = trace_id
        if request_id:
            ctx["request_id"] = request_id
        for key, value in extra.items():
            if value:
                ctx[key] = value
        return _ContextBinding(self, ctx)

    def context(self) -> dict:
        """A copy of the current thread's bound trace context (``{}`` when
        unbound) — e.g. ``trace.context().get("trace_id")``."""
        return dict(getattr(self._tls, "ctx", None) or {})

    def record(self, name, t0, t1, **attrs):
        """Record an already-timed span (``perf_counter`` endpoints) without
        entering a context manager — for threads attributing work that began
        elsewhere, like the engine loop recording a request's queue wait
        from its admission-thread enqueue timestamp."""
        if not runtime.enabled():
            return
        self._record(name, t0, t1, None, attrs)

    def _record(self, name, t0, t1, parent, attrs):
        ident = threading.get_ident()
        args = dict(attrs)
        ctx = getattr(self._tls, "ctx", None)
        if ctx:
            for key, value in ctx.items():
                args.setdefault(key, value)
        if parent is not None:
            args["parent"] = parent
        if self._correlated:
            rid = _correlate.current()
            if rid is not None:
                args["run_id"] = rid
        with self._lock:
            tid = self._tids.setdefault(ident, len(self._tids))
            event = {
                "name": name,
                "cat": "distkeras",
                "ph": "X",
                "pid": self._pid if self._pid is not None else os.getpid(),
                "tid": tid,
                "ts": round((t0 - self._origin) * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "args": args,
            }
            self._events.append(event)
        if self._correlated:
            _flight_recorder.record_span(event)

    def reset(self):
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self._origin = self._clock()

    # --------------------------------------------------------------- export

    def events(self):
        with self._lock:
            return [dict(e) for e in self._events]

    def export(self) -> dict:
        """Chrome trace-event JSON object; open in Perfetto / chrome://tracing."""
        evs = self.events()
        evs.sort(key=lambda e: (e["tid"], e["ts"], -e["dur"]))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write(self, path) -> str:
        payload = self.export()
        # tmp + replace: dktrace merge / flightdeck may read this file from
        # another process while a dump is still streaming out
        tmp = os.fspath(path) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1)
        os.replace(tmp, path)
        return path


# Process-global tracer used by all instrumentation sites; correlated so its
# events carry the fleet run_id and land in the flight-recorder ring.
trace = Tracer(correlated=True)
