"""Flight recorder: a bounded ring of recent telemetry, dumped on crash.

The port of :mod:`distkeras_tpu.telemetry.flightdeck.recorder` (host code,
copied); the run configuration it dumps is the ``DISTKERAS_*``, ``TORCH_*``
and ``CUDA_*`` environment.

The flush-at-exit telemetry files answer "what happened over the whole run";
the flight recorder answers "what happened in the last few seconds before it
died".  It is a fixed-size ring — a preallocated list plus a monotonically
increasing index, both touched under one cheap lock — fed by the correlated
tracer (every finished span), the metrics registry (every counter/gauge
delta while telemetry is on), the :class:`DivergenceWatchdog` (every
observation), and the sanitizer (every violation).  Recording is a tuple
store; the per-event overhead is pinned by test next to the span fast path.

On an unhandled trainer exception, a watchdog halt, a strict sanitizer
violation, or a daemon job crash, :func:`blackbox_dump` serialises the ring
together with the run configuration (``DISTKERAS_*`` environment),
process facts, the last dynamics summary, and a full metrics snapshot into
``blackbox_<run_id>_<pid>.json`` in the telemetry directory — the black box
an operator opens first.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from distkeras_tpu_torch.telemetry import runtime as _runtime
from distkeras_tpu_torch.telemetry.flightdeck import correlate

__all__ = ["FlightRecorder", "blackbox_dump", "on_crash", "recorder"]

DEFAULT_CAPACITY = 2048

# /healthz liveness map: bounded number of distinct span names tracked.
_MAX_LAST_SPANS = 64


class FlightRecorder:
    """Bounded in-memory ring of recent telemetry events.

    Entries are ``(kind, name, unix, perf, data, event)`` tuples — ``kind``
    one of ``span``/``metric``/``watchdog``/``sanitizer``, ``unix`` the wall
    timestamp (for humans), ``perf`` the ``perf_counter`` reading (for trace
    export), ``data`` a small JSON-safe payload, ``event`` the full Chrome
    trace event dict for spans.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: List[Any] = [None] * self.capacity
        self._idx = 0
        self._last_spans: Dict[str, float] = {}
        self._watchdog: Optional[Dict[str, Any]] = None
        self._started_perf = time.perf_counter()

    # ------------------------------------------------------------- recording

    def record(self, kind: str, name: str, data=None, event=None) -> None:
        """Append one entry: a tuple build and a list store under the lock."""
        entry = (kind, name, time.time(), time.perf_counter(), data, event)
        with self._lock:
            self._buf[self._idx % self.capacity] = entry
            self._idx += 1
            if kind == "span" and (
                name in self._last_spans or len(self._last_spans) < _MAX_LAST_SPANS
            ):
                self._last_spans[name] = entry[2]

    def record_span(self, event: Dict[str, Any]) -> None:
        """Fed by the correlated tracer with the already-built trace event."""
        self.record("span", event["name"], event=event)

    def record_metric(self, name: str, value: float) -> None:
        self.record("metric", name, data={"value": value})

    def record_watchdog(self, payload: Dict[str, Any]) -> None:
        with self._lock:
            self._watchdog = payload
        self.record("watchdog", payload.get("action", "observe"), data=payload)

    def record_sanitizer(self, kind: str, message: str, strict: bool) -> None:
        self.record(
            "sanitizer", kind, data={"message": message, "strict": strict}
        )

    # ----------------------------------------------------------- inspection

    def events(self) -> List[Dict[str, Any]]:
        """Ring contents, oldest first, as JSON-safe dicts."""
        with self._lock:
            if self._idx <= self.capacity:
                raw = self._buf[: self._idx]
            else:
                head = self._idx % self.capacity
                raw = self._buf[head:] + self._buf[:head]
        out = []
        for kind, name, unix, perf, data, event in raw:
            d = {"kind": kind, "name": name, "unix": unix, "perf": perf}
            if data is not None:
                d["data"] = data
            if event is not None:
                d["event"] = event
            out.append(d)
        return out

    def last_spans(self) -> Dict[str, float]:
        """Span name -> wall timestamp of its most recent completion (the
        /healthz liveness signal: a live fit keeps bumping ``epoch``)."""
        with self._lock:
            return dict(self._last_spans)

    def last_event_unix(self) -> Optional[float]:
        with self._lock:
            if self._idx == 0:
                return None
            return self._buf[(self._idx - 1) % self.capacity][2]

    def watchdog_state(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._watchdog

    def uptime_seconds(self) -> float:
        return time.perf_counter() - self._started_perf

    def trace_export(self, origin: Optional[float] = None) -> Dict[str, Any]:
        """The ring as a Chrome trace object (the /trace endpoint).

        Span entries carry their original trace events; everything else
        becomes an instant event on tid 0, placed on the same microsecond
        axis via ``origin`` (the live tracer's perf origin).
        """
        evs = self.events()
        if origin is None:
            origin = min((e["perf"] for e in evs), default=0.0)
        out = []
        pid = os.getpid()
        for e in evs:
            if e["kind"] == "span":
                out.append(e["event"])
                continue
            out.append({
                "name": f'{e["kind"]}:{e["name"]}',
                "cat": "distkeras",
                "ph": "i",
                "s": "p",
                "pid": pid,
                "tid": 0,
                "ts": round((e["perf"] - origin) * 1e6, 3),
                "args": e.get("data") or {},
            })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._idx = 0
            self._last_spans.clear()
            self._watchdog = None
            self._started_perf = time.perf_counter()


#: Process-global recorder every instrumentation site feeds.
recorder = FlightRecorder()


def blackbox_dump(reason: str, directory=None, extra=None) -> Optional[str]:
    """Write ``blackbox_<run_id>_<pid>.json`` and return its path.

    ``None`` when telemetry is disabled.  The payload is self-contained:
    ring, run/environment configuration, last dynamics summary, watchdog
    state, and a full metrics snapshot — everything needed to diagnose a
    dead process without its (possibly never-flushed) telemetry files.
    """
    if not _runtime.enabled():
        return None
    # Lazy: keeps this module import-light and cycle-free (metrics imports
    # the recorder for its ring feed).
    from distkeras_tpu_torch.telemetry import dynamics as _dynamics
    from distkeras_tpu_torch.telemetry.metrics import metrics as _registry

    rid = correlate.run_id()
    pid = os.getpid()
    payload = {
        "reason": reason,
        "run_id": rid,
        "pid": pid,
        "unix": time.time(),
        "config": {
            k: v
            for k, v in sorted(os.environ.items())
            if k.startswith(("DISTKERAS_", "TORCH_", "CUDA_"))
        },
        "process": {
            "argv": list(sys.argv),
            "cwd": os.getcwd(),
            "python": sys.version.split()[0],
        },
        "dynamics": _dynamics.last_summary(),
        "watchdog": recorder.watchdog_state(),
        "metrics": _registry.snapshot(),
        "ring": recorder.events(),
    }
    if extra:
        payload["extra"] = extra
    d = directory or _runtime.out_dir()
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"blackbox_{rid}_{pid}.json")
    # tmp + replace: post-mortem tooling globs blackbox_*.json from another
    # process; the crashing dump must appear complete or not at all
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=1, default=repr)
    os.replace(tmp, path)
    _registry.counter(
        "telemetry_blackbox_dumps_total",
        help="flight-recorder blackbox files written on crash boundaries",
    ).inc()
    return path


def on_crash(reason: str, directory=None, extra=None) -> Optional[str]:
    """Best-effort :func:`blackbox_dump` at a crash boundary.

    Swallows everything: forensics must never mask the original exception
    that is about to propagate.
    """
    try:
        return blackbox_dump(reason, directory=directory, extra=extra)
    except Exception:  # noqa: BLE001 — crash path; the real error re-raises
        return None
