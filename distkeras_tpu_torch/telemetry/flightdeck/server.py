"""Live HTTP exporter: scrape a running trainer/daemon instead of waiting.

The port of :mod:`distkeras_tpu.telemetry.flightdeck.server` (host code,
copied).

A stdlib :class:`http.server.ThreadingHTTPServer` on a daemon thread, gated
by ``DISTKERAS_TELEMETRY_HTTP``:

* unset / empty — off (the default; nothing binds, nothing serves);
* ``<port>`` — serve on ``127.0.0.1:<port>``;
* ``0`` — serve on an ephemeral port, discoverable in-process via
  :func:`address` and across processes via the ``flightdeck_<pid>.json``
  discovery file the server drops into the telemetry directory (how the
  ``PunchcardServer`` finds its jobs' live ports).

Endpoints:

``/metrics``
    Prometheus text from the process-global registry, every sample labelled
    with the fleet ``run_id``.
``/healthz``
    Liveness: uptime, last event / last span-completion timestamps,
    watchdog state, sanitizer mode and violation tallies.
``/vars``
    JSON: full metrics snapshot, phase breakdown, last dynamics summary.
``/trace``
    The flight-recorder ring as Chrome trace JSON (open in Perfetto).
    ``?request_id=`` / ``?trace_id=`` filter the span events to one
    request's trace — the live half of ``dktrace critical-path``.
``/timeseries``
    The rollup ring (``DISTKERAS_ROLLUP``): fixed-interval history of every
    instrument, the raw feed for SLO burn rates and ``dkmon watch``.
    ``?since=<unix>`` / ``?name=<metric>`` (repeatable) filter the samples.
``/ledger``
    The per-tenant accounting ledger (``DISTKERAS_ACCOUNTING``) as JSON;
    ``{"enabled": false, "tenants": []}`` when accounting is off.
Handlers only *read* registry snapshots and the recorder ring (each guarded
by its own cheap lock), so scraping never blocks the training loop.  The
daemon adds its fleet ``/aggregate`` view through :func:`add_endpoint`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs

from distkeras_tpu_torch.telemetry import runtime as _runtime
from distkeras_tpu_torch.telemetry.flightdeck import correlate
from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder as _flight_recorder

__all__ = [
    "add_endpoint",
    "address",
    "configure",
    "ensure_server",
    "get_vars",
    "http_port",
    "set_var",
    "stop",
]

_UNSET = object()

# _UNSET = not yet resolved from the environment; None = off; int = port
# (0 = ephemeral) once resolved or forced via configure().
_PORT = _UNSET

_SERVER: Optional[ThreadingHTTPServer] = None
_THREAD: Optional[threading.Thread] = None
_LOCK = threading.Lock()

# Extra endpoint registry: path -> handler.  Zero-arg handlers return
# (content_type, body); handlers that accept an argument get a request dict
# {"method", "query", "body", "headers"} and may return a (ctype, body,
# status) triple (how the serving /generate endpoint speaks 400/503).
_EXTRA: Dict[str, Callable] = {}

# Free-form string/scalar vars surfaced under /vars "vars": the place for
# one-off facts that are not metric-shaped (e.g. bench's
# bench_backend_init_reason — *why* the device backend fell back).
_VARS: Dict[str, object] = {}
_VARS_LOCK = threading.Lock()


def set_var(name: str, value) -> None:
    """Publish a JSON-safe scalar under ``/vars``' ``"vars"`` key."""
    with _VARS_LOCK:
        _VARS[str(name)] = value


def get_vars() -> Dict[str, object]:
    with _VARS_LOCK:
        return dict(_VARS)


def http_port() -> Optional[int]:
    """Resolved exporter port (``0`` = ephemeral) or ``None`` when off.
    Cached after the first environment read."""
    global _PORT
    if _PORT is _UNSET:
        raw = os.environ.get("DISTKERAS_TELEMETRY_HTTP", "").strip()
        if raw == "" or raw.lower() in ("off", "false", "no"):
            _PORT = None
        else:
            _PORT = int(raw)
    return _PORT


def configure(port=_UNSET) -> None:
    """Force the exporter port (int, ``0`` = ephemeral), turn it off
    (``False``), or reset to env-driven (``None``, re-read lazily)."""
    global _PORT
    if port is None:
        _PORT = _UNSET
    elif port is False:
        _PORT = None
    else:
        _PORT = int(port)


def ensure_server() -> Optional[str]:
    """Start the exporter once (idempotent) and return its address.

    ``None`` when telemetry is disabled or no port is configured — callers
    sprinkle this at entry points without checking anything first.
    """
    if not _runtime.enabled():
        return None
    port = http_port()
    if port is None:
        return None
    global _SERVER, _THREAD
    with _LOCK:
        if _SERVER is None:
            srv = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
            srv.daemon_threads = True
            thread = threading.Thread(
                target=srv.serve_forever, name="flightdeck-http", daemon=True
            )
            thread.start()
            _SERVER, _THREAD = srv, thread
            _write_discovery_file()
    return address()


def address() -> Optional[str]:
    """``"127.0.0.1:<port>"`` of the live exporter, or ``None``."""
    srv = _SERVER
    if srv is None:
        return None
    host, port = srv.server_address[:2]
    return f"{host}:{port}"


def stop() -> None:
    """Shut the exporter down (tests and daemon teardown)."""
    global _SERVER, _THREAD
    with _LOCK:
        srv, _SERVER = _SERVER, None
        thread, _THREAD = _THREAD, None
    if srv is not None:
        srv.shutdown()
        srv.server_close()
    if thread is not None:
        thread.join(timeout=5)


def add_endpoint(path: str, fn: Callable) -> None:
    """Register an extra endpoint.

    Two handler shapes, told apart by signature:

    * ``fn() -> (content_type, body)`` — read-only GET view (the daemon's
      fleet ``/aggregate``);
    * ``fn(request) -> (content_type, body[, status[, headers]])`` —
      request-aware: ``request`` is ``{"method": "GET"|"POST", "query":
      <raw query string>, "body": <decoded POST body or "">, "headers":
      <lower-cased request-header dict>}``, the optional third element
      sets the HTTP status (the serving ``/generate`` endpoint's
      400/503/504), and the optional fourth is a dict of extra response
      headers (e.g. ``Retry-After`` on a 503).  Request-aware endpoints
      also receive POSTs.
    """
    _EXTRA[path] = fn


def _wants_request(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    return len(sig.parameters) >= 1


def _write_discovery_file() -> None:
    # Advisory: lets other processes (the daemon's status verb) find this
    # process's ephemeral port.  The exporter itself is already serving, so
    # an unwritable telemetry dir must not take it down.  tmp + replace:
    # the daemon polls this file from another process, and a bare in-place
    # dump would let it read half-written JSON.
    try:
        d = _runtime.out_dir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flightdeck_{os.getpid()}.json")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(
                {
                    "address": address(),
                    "pid": os.getpid(),
                    "run_id": correlate.run_id(),
                },
                fh,
            )
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        pass


# ------------------------------------------------------------------ handler


def _event_matches(event: dict, request_id: str, trace_id: str) -> bool:
    """Does a trace event belong to the given request/trace?  Matches the
    direct ``args.request_id``/``args.trace_id`` stamps and the batched
    decode-step spellings (``args.requests`` list, ``args.trace_ids``)."""
    args = event.get("args") or {}
    if request_id:
        if args.get("request_id") == request_id:
            return True
        if request_id in (args.get("requests") or ()):
            return True
    if trace_id:
        if args.get("trace_id") == trace_id:
            return True
        if trace_id in (args.get("trace_ids") or ()):
            return True
    return False


def _render(path: str, request: Optional[dict] = None):
    """``(content_type, body, status[, headers])`` for one endpoint,
    ``None`` for 404."""
    # Lazy: metrics/trace/dynamics import this package for their ring feeds.
    from distkeras_tpu_torch import sanitizer as _sanitizer
    from distkeras_tpu_torch.telemetry import dynamics as _dynamics
    from distkeras_tpu_torch.telemetry.metrics import metrics as _registry
    from distkeras_tpu_torch.telemetry.trace import trace as _tracer

    rec = _flight_recorder
    rid = correlate.run_id()
    if path == "/metrics":
        text = _registry.to_prometheus(labels={"run_id": rid})
        return ("text/plain; version=0.0.4; charset=utf-8", text, 200)
    if path == "/healthz":
        counts: Dict[str, int] = {}
        for kind, _msg in _sanitizer.violations():
            counts[kind] = counts.get(kind, 0) + 1
        body = {
            "status": "ok",
            "run_id": rid,
            "pid": os.getpid(),
            "unix": time.time(),
            "uptime_seconds": round(rec.uptime_seconds(), 3),
            "last_event_unix": rec.last_event_unix(),
            "last_spans": rec.last_spans(),
            "watchdog": rec.watchdog_state(),
            "sanitizer": {"mode": _sanitizer.mode(), "violations": counts},
        }
        return ("application/json", json.dumps(body), 200)
    if path == "/vars":
        body = {
            "run_id": rid,
            "pid": os.getpid(),
            "metrics": _registry.snapshot(),
            "phase_breakdown": _registry.phase_breakdown(),
            "dynamics": _dynamics.last_summary(),
            "vars": get_vars(),
        }
        return ("application/json", json.dumps(body), 200)
    if path == "/timeseries":
        from distkeras_tpu_torch.telemetry.flightdeck import rollup as _rollup

        return _rollup.timeseries_view(request)
    if path == "/ledger":
        from distkeras_tpu_torch.telemetry import accounting as _accounting

        return _accounting.ledger_view(request)
    if path == "/trace":
        payload = rec.trace_export(origin=_tracer._origin)
        query = parse_qs((request or {}).get("query") or "")
        want_rid = (query.get("request_id") or [""])[-1]
        want_tid = (query.get("trace_id") or [""])[-1]
        if want_rid or want_tid:
            payload = dict(payload)
            payload["traceEvents"] = [
                e for e in payload.get("traceEvents", [])
                if _event_matches(e, want_rid, want_tid)
            ]
        return ("application/json", json.dumps(payload), 200)
    fn = _EXTRA.get(path)
    if fn is not None:
        out = fn(request or {"method": "GET", "query": "", "body": ""}) \
            if _wants_request(fn) else fn()
        if len(out) == 2:
            return (out[0], out[1], 200)
        return out
    return None


class _Handler(BaseHTTPRequestHandler):
    server_version = "distkeras-flightdeck"

    def log_message(self, fmt, *args):  # noqa: D102 — silence stderr access log
        pass

    def _dispatch(self, method: str) -> None:
        path, _, query = self.path.partition("?")
        body = ""
        if method == "POST":
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length).decode("utf-8", "replace")
            if path not in _EXTRA:
                self._reply(405, "text/plain",
                            "POST only supported on registered endpoints")
                return
        request = {
            "method": method,
            "query": query,
            "body": body,
            "headers": {k.lower(): v for k, v in self.headers.items()},
        }
        try:
            payload = _render(path, request)
        except Exception as e:  # noqa: BLE001 — a scrape must never kill training
            self._reply(500, "text/plain", f"{type(e).__name__}: {e}")
            return
        if payload is None:
            known = ["/metrics", "/healthz", "/vars", "/trace",
                     "/timeseries", "/ledger", *sorted(_EXTRA)]
            self._reply(404, "text/plain", "not found; endpoints: " + " ".join(known))
            return
        ctype, text, status = payload[:3]
        headers = payload[3] if len(payload) > 3 else None
        self._reply(status, ctype, text, headers)

    def do_GET(self):  # noqa: N802 — http.server API
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802 — http.server API
        self._dispatch("POST")

    def _reply(self, code: int, ctype: str, body: str,
               headers: Optional[Dict[str, str]] = None) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for key, value in (headers or {}).items():
            self.send_header(key, str(value))
        self.end_headers()
        self.wfile.write(data)
