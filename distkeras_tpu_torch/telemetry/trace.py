"""Span tracer recording Chrome trace events.

The port of :mod:`distkeras_tpu.telemetry.trace` as far as the predictor
uses it:

    with trace.span("predict", rows=n):
        with trace.span("predict_batch", phase="infer"):
            ...

Spans clock with ``time.perf_counter``, nest per thread, and are recorded as
complete (``"ph": "X"``) events carrying an explicit ``args.parent``.  With
telemetry off, ``span()`` returns a shared no-op context manager.  The
``phase=`` histograms, trace export, request-trace binding and flight
recorder of the JAX package come with the telemetry slice; until then
``phase`` is accepted and not recorded.
"""

from __future__ import annotations

import os
import threading
import time

from distkeras_tpu_torch.telemetry import runtime

__all__ = ["NOOP_SPAN", "Span", "Tracer", "trace"]


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """Context manager recording one complete trace event on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_t0")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._tracer._push(self.name)
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self._tracer._clock()
        parent = self._tracer._pop()
        self._tracer._record(self.name, self._t0, t1, parent, self.attrs)
        return False


class Tracer:
    """Thread-safe span recorder."""

    def __init__(self):
        self._clock = time.perf_counter
        self._lock = threading.Lock()
        self._events = []
        self._tls = threading.local()
        self._tids = {}
        self._origin = self._clock()

    def span(self, name, phase=None, **attrs):
        if not runtime.enabled():
            return NOOP_SPAN
        del phase  # read by the phase histograms of the telemetry slice
        return Span(self, name, attrs)

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

    def _record(self, name, t0, t1, parent, attrs):
        args = dict(attrs)
        if parent is not None:
            args["parent"] = parent
        with self._lock:
            tid = self._tids.setdefault(threading.get_ident(), len(self._tids))
            self._events.append({
                "name": name,
                "cat": "distkeras",
                "ph": "X",
                "pid": os.getpid(),
                "tid": tid,
                "ts": round((t0 - self._origin) * 1e6, 3),
                "dur": round((t1 - t0) * 1e6, 3),
                "args": args,
            })

    def reset(self):
        with self._lock:
            self._events.clear()
            self._tids.clear()
            self._origin = self._clock()

    def events(self):
        """Copies of the recorded Chrome trace events."""
        with self._lock:
            return [dict(e) for e in self._events]


#: process-global tracer used by the instrumentation sites
trace = Tracer()
