"""Admission layer for the serving engine: requests and queueing.

The port of :mod:`distkeras_tpu.serving.frontend`, host-side Python copied
from the JAX package:

* :class:`GenerateRequest` / :class:`GenerateResult` — the wire-shaped
  request/response dataclasses (sampling knobs, per-request seed, EOS id).
* :class:`RequestQueue` — a bounded queue with **backpressure rejection**:
  ``put`` raises :class:`QueueFull` instead of blocking, so an overloaded
  engine sheds load at admission rather than stacking unbounded latency.
* :func:`serve_flags` and the request parser of the ``/generate`` endpoint.

:func:`install_http_endpoint` mounts ``/generate`` on the flight deck's
HTTP server.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import deque
from typing import List, Optional
from urllib.parse import parse_qs

__all__ = [
    "GenerateRequest",
    "GenerateResult",
    "QueueFull",
    "RequestQueue",
    "install_http_endpoint",
    "serve_flags",
]


class QueueFull(Exception):
    """Raised by :meth:`RequestQueue.put` when the queue is at capacity —
    the backpressure signal (HTTP layer: 503)."""


@dataclasses.dataclass
class GenerateRequest:
    """One generation request.

    ``temperature <= 0`` (default) means greedy decode; ``seed`` fixes the
    sampling RNG chain so a request's tokens are deterministic regardless
    of what else shares the batch; ``eos_id`` retires the request early
    when that token is emitted.  ``speculative`` opts a single request in
    (True) or out (False) of the engine's draft-model fast path; None
    (default) follows the engine — speculative whenever it has a draft.
    ``timeout_s`` is the caller's *remaining* deadline budget (read by
    the HTTP endpoint).  ``trace_id`` correlates the spans the request
    produces; ``request_id`` is the idempotency key; both ride trace-span
    args, never metric labels.  ``tenant`` names the client on whose
    behalf the request runs: it rides span args and is the key the
    engine's per-tenant ledger bills (:mod:`~distkeras_tpu_torch.telemetry.
    accounting`; an empty tenant bills ``__untagged__``).  Over HTTP it is
    the body's ``tenant``, else the ``x-dk-tenant`` header.
    """

    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    eos_id: Optional[int] = None
    request_id: str = ""
    speculative: Optional[bool] = None
    timeout_s: Optional[float] = None
    trace_id: str = ""
    tenant: str = ""

    def validate(self) -> None:
        if not self.prompt:
            raise ValueError("prompt must be non-empty")
        if any(int(t) < 0 for t in self.prompt):
            raise ValueError("prompt token ids must be >= 0")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not (0.0 <= self.top_p <= 1.0):
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")


@dataclasses.dataclass
class GenerateResult:
    """Engine output for one request.  ``tokens`` excludes the prompt;
    ``finish_reason`` is ``"eos"``, ``"length"``, or ``"aborted"`` (engine
    stopped with the request in flight)."""

    request_id: str
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    ttft_s: float = 0.0
    latency_s: float = 0.0
    trace_id: str = ""

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


class RequestQueue:
    """Bounded FIFO with reject-on-full semantics.

    The engine's admission loop is the single consumer; any thread may
    produce.  ``put`` never blocks — a full queue is an *error* the caller
    must surface (backpressure), not a wait."""

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = int(maxsize)
        self._items: deque = deque()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._items)

    def put(self, item) -> None:
        with self._lock:
            if len(self._items) >= self.maxsize:
                raise QueueFull(
                    f"serving queue at capacity ({self.maxsize}); retry later"
                )
            self._items.append(item)

    def pop(self):
        """Next item or ``None`` when empty (engine loop polls between
        decode steps; it never blocks on the queue)."""
        with self._lock:
            if not self._items:
                return None
            return self._items.popleft()

    def remove(self, item) -> bool:
        """Remove a queued item (identity match) before the engine admits
        it; ``False`` if it is no longer queued.  The cancellation fast
        path: a request that never reached a slot frees nothing."""
        with self._lock:
            for i, queued in enumerate(self._items):
                if queued is item:
                    del self._items[i]
                    return True
            return False

    def requeue_front(self, item) -> None:
        """Put a popped item back at the head — the engine's head-of-line
        blocking when the page pool can't fit it yet.  May transiently
        exceed ``maxsize`` by the one in-flight item; that's the popped
        item returning, not new admission."""
        with self._lock:
            self._items.appendleft(item)


# ---------------------------------------------------------------- HTTP


def _parse_tristate(value) -> Optional[bool]:
    """``speculative`` over the wire: absent/empty -> None (engine default),
    otherwise the usual JSON/query truthy spellings."""
    if value in (None, "", "None", "null"):
        return None
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("1", "true", "yes", "on")


def serve_flags() -> dict:
    """Engine construction knobs passed down by the job daemon's ``serve``
    verb (``Job.serve(flags=...)``) as the ``DISTKERAS_SERVE_FLAGS`` JSON
    env var — e.g. ``{"spec_tokens": 4, "num_slots": 8}``.  Serve scripts
    splat this into the engine: ``ServingEngine(model, params,
    **serve_flags())``.  Returns ``{}`` when unset or unparseable (a broken
    deploy flag should degrade to defaults, not kill the serving job)."""
    import os

    try:
        flags = json.loads(os.environ.get("DISTKERAS_SERVE_FLAGS") or "{}")
    except ValueError:
        return {}
    return flags if isinstance(flags, dict) else {}


def _parse_request(request: dict) -> GenerateRequest:
    """Build a :class:`GenerateRequest` from the flightdeck request dict
    (``method``/``query``/``body``/``headers``).  GET:
    ``prompt=1,2,3&max_new_tokens=8``; POST: the same fields as a JSON
    object with ``prompt`` a list.  ``request_id``/``trace_id`` fall back
    to the ``X-DK-Request-Id``/``X-DK-Trace-Id`` headers the router's HTTP
    hop sets, so trace context survives even a body that omits them."""
    if request.get("method") == "POST":
        payload = json.loads(request.get("body") or "{}")
    else:
        qs = parse_qs(request.get("query") or "")
        payload = {k: v[-1] for k, v in qs.items()}
        if "prompt" in payload:
            payload["prompt"] = [
                int(t) for t in str(payload["prompt"]).split(",") if t != ""
            ]
    req = GenerateRequest(
        prompt=[int(t) for t in payload.get("prompt", [])],
        max_new_tokens=int(payload.get("max_new_tokens", 16)),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=int(payload.get("top_k", 0)),
        top_p=float(payload.get("top_p", 1.0)),
        seed=int(payload.get("seed", 0)),
        eos_id=(None if payload.get("eos_id") in (None, "", "None")
                else int(payload["eos_id"])),
        request_id=str(payload.get("request_id", "")),
        speculative=_parse_tristate(payload.get("speculative")),
        timeout_s=(None if payload.get("timeout_s") in (None, "", "None")
                   else float(payload["timeout_s"])),
        trace_id=str(payload.get("trace_id", "")),
        tenant=str(payload.get("tenant", "")),
    )
    headers = request.get("headers") or {}
    if not req.request_id:
        req.request_id = str(headers.get("x-dk-request-id", ""))
    if not req.trace_id:
        req.trace_id = str(headers.get("x-dk-trace-id", ""))
    if not req.tenant:
        req.tenant = str(headers.get("x-dk-tenant", ""))
    req.validate()
    return req


def install_http_endpoint(engine, path: str = "/generate",
                          timeout: Optional[float] = None,
                          traffic_log=None) -> str:
    """Mount a ``/generate`` endpoint for ``engine`` on the flight deck's
    HTTP exporter (:mod:`distkeras_tpu_torch.telemetry.flightdeck.server`,
    which serves only with telemetry on and ``DISTKERAS_TELEMETRY_HTTP``
    set, or ``server.configure(port)``).  Blocking request/response: the
    handler thread (the exporter runs one per connection) submits and waits
    for the result.  A request carrying ``timeout_s`` (the caller's
    remaining deadline budget) bounds its own wait to that remainder.  On
    timeout the pending request is cancelled so the engine reclaims its
    slot and pages — the 504 is a release, not a leak.  Returns the
    mounted path.

    The handler mints the trace context: a request that arrives without
    ``trace_id``/``request_id`` gets fresh ids here, and the whole handler
    runs inside a ``serving.http_request`` span bound to them;
    ``X-DK-Parent-Span`` names the caller-side span this one nests under.

    ``traffic_log`` (capture of served traffic for online training) comes
    with ROADMAP Queue A item 18 and is refused until then."""
    import uuid as _uuid

    from distkeras_tpu_torch.telemetry.flightdeck import server as _server
    from distkeras_tpu_torch.telemetry.trace import new_trace_id, trace as _trace

    if traffic_log is not None:
        raise NotImplementedError(
            "traffic_log is not ported yet: it comes with ROADMAP Queue A item 18 "
            "(the online loop)"
        )

    def handle(request):
        try:
            req = _parse_request(request)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            body = json.dumps({"error": f"{type(e).__name__}: {e}"})
            return ("application/json", body, 400)
        if not req.request_id:
            req.request_id = _uuid.uuid4().hex
        if not req.trace_id:
            req.trace_id = new_trace_id()
        span_attrs = {"request_id": req.request_id, "trace_id": req.trace_id}
        if req.tenant:
            span_attrs["tenant"] = req.tenant
        parent = (request.get("headers") or {}).get("x-dk-parent-span")
        if parent:
            span_attrs["parent"] = str(parent)
        with _trace.bind(trace_id=req.trace_id, request_id=req.request_id), \
                _trace.span("serving.http_request", **span_attrs):
            try:
                pending = engine.submit(req)
            except QueueFull as e:
                return ("application/json", json.dumps({"error": str(e)}),
                        503, {"Retry-After": "1"})
            budget = timeout
            if req.timeout_s is not None:
                budget = req.timeout_s if budget is None else min(budget, req.timeout_s)
            result = pending.result(timeout=budget)
            if result is None:
                engine.cancel(pending)
                body = json.dumps({"error": "generation timed out"})
                return ("application/json", body, 504)
            if result.finish_reason == "aborted":
                # engine stopped or crashed with the request in flight — a
                # retryable server condition, not a successful generation
                return ("application/json", result.to_json(), 503,
                        {"Retry-After": "1"})
            return ("application/json", result.to_json(), 200)

    _server.add_endpoint(path, handle)
    return path
