"""Fault-tolerant serving tier: a health-gated router over N replicas.

The port of :mod:`distkeras_tpu.serving.tier`, host code copied: the same
states, metric names, routing, failover and roll.  One engine behind one
``/generate`` loses every in-flight request when it crashes; this module
routes over several, with the fleet's lease discipline
(:class:`~distkeras_tpu_torch.fleet.FleetMembership` underneath) applied
to inference replicas.

* **Health state machine** per replica, driven by probes (flightdeck
  ``/healthz`` + the live queue/slot gauges for HTTP replicas, the
  engine's own ``alive``/``stats()`` for in-process ones)::

      starting ──probe ok──▶ healthy ◀──probe ok── degraded
                                │  probe failed ▲      │ lease expired
                                ▼───────────────┘      ▼
      draining (explicit, during a roll)             dead

  ``dead`` is reversible for a replica that was merely wedged (a later
  successful probe resurrects it, epoch-bumped like a fleet rejoin), and
  immediate for a provably crashed one (:class:`ReplicaDead` from the
  probe: engine crashed, serve-job Popen dead).

* **Least-loaded dispatch** — ``queue_depth + active_slots`` from the
  last probe plus the router's own in-flight count, healthy replicas
  preferred over degraded ones.

* **Failover retry** — a request whose replica died mid-flight is re-run
  on another replica.  Generation is a function of (params, prompt, knobs,
  seed): a seeded sampled request draws from its own counter-based stream
  (ROADMAP C9), so the retry draws the same tokens given the same logits.
  On a card two engines batch differently and their products may round
  differently, so a retried greedy token can depart only where the
  reference's two best logits are within rounding of each other.
  Attempts are capped with jittered exponential backoff, and an
  idempotency discipline guarantees a retry never *double-executes* on a
  slow-but-alive replica: in-process replicas confirm cancellation before
  the retry dispatches (``engine.cancel`` + wait for the handle to
  resolve), HTTP replicas receive the hop budget as ``timeout_s`` so
  their own handler 504s — and self-cancels — no later than the router
  gives up on them.

* **Deadline propagation** — one budget per request, decremented per hop
  and forwarded as ``timeout_s``; when it runs out the router answers 504
  itself instead of stacking N independent timeouts.

* **Load shedding** — when every dispatchable replica is saturated the
  router sheds (503 + ``Retry-After``) instead of queueing unbounded.

* **Rolling checkpoint hot-swap** — :meth:`ServingTier.watch_checkpoints`
  polls a checkpoint directory (manifest commit records, no cross-process
  flush), re-verifies each candidate step's digests at swap time (a
  corrupt one is rejected — ``serving_checkpoint_rejected_total`` — and
  the fleet keeps its params), and :meth:`ServingTier.roll` swaps the
  fleet one replica at a time: drain → param swap on the engine's loop
  thread (shapes kept, zero dropped requests) → wait until the replica
  probes healthy again — so ≥1 replica stays dispatchable throughout.  A
  loader that returns parameters already on the card is applied to every
  replica without a copy (``ServingEngine`` moves a tensor only when it is
  on another device).

Everything is observable: ``serving_tier_*`` counters (failovers, hedges,
sheds, hot swaps), a per-replica health gauge, and router-level SLO
histograms (end-to-end latency, attempts per request).
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from distkeras_tpu_torch import chaos as _chaos
from distkeras_tpu_torch.fleet import FleetMembership
from distkeras_tpu_torch.sanitizer import lockwatch
from distkeras_tpu_torch.serving.engine import EngineCrashed
from distkeras_tpu_torch.serving.frontend import (
    GenerateRequest,
    GenerateResult,
    QueueFull,
)
from distkeras_tpu_torch.telemetry import accounting as _accounting
from distkeras_tpu_torch.telemetry import runtime as _truntime
from distkeras_tpu_torch.telemetry.trace import (
    NOOP_SPAN,
    new_trace_id,
    trace as _trace,
)


def _span_note(span, **kv) -> None:
    """Annotate a live span's args in place (no-op for the disabled-path
    NOOP span) — how an attempt's *outcome* lands on a span that had to
    open before the outcome was known."""
    attrs = getattr(span, "attrs", None)
    if attrs is not None:
        attrs.update(kv)


__all__ = [
    "HttpReplica",
    "LocalReplica",
    "REPLICA_STATES",
    "ReplicaDead",
    "ServingTier",
    "TierDeadline",
    "TierError",
    "TierExhausted",
    "TierSaturated",
    "install_tier_endpoint",
    "tier_metrics",
    "watch_and_swap",
]

#: health states, in gauge-ordinal order
REPLICA_STATES = ("starting", "healthy", "degraded", "draining", "dead")


class ReplicaDead(ConnectionError):
    """A probe's *fatal* verdict: the replica is provably gone (engine
    crashed, serve-job process dead), not merely slow — the router evicts
    it immediately instead of waiting out the lease."""


class TierError(RuntimeError):
    """Base for router-level request failures."""


class TierDeadline(TierError):
    """The request's deadline budget ran out at the router (HTTP 504)."""


class TierSaturated(TierError):
    """Every dispatchable replica is saturated or unavailable — the
    router sheds the request (HTTP 503 + ``Retry-After``)."""


class TierExhausted(TierError):
    """The failover attempt cap was reached without a completed
    generation (HTTP 502)."""


def _ckpt_rejected_counter(registry=None):
    """The swap-time verification rejection counter — shared between the
    router's :meth:`ServingTier.watch_checkpoints` and the replica-side
    :func:`watch_and_swap` so both publication paths count into one name."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return registry.counter(
        "serving_checkpoint_rejected_total",
        help="checkpoint steps that failed re-verification at swap time "
             "(replicas kept the old params)",
    )


def tier_metrics(registry=None) -> dict:
    """Get-or-create the router's instruments (default: process-global
    registry).  One canonical home for names/help so the router, the
    golden test, and the CI chaos smoke assert the same schema."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return {
        "ckpt_rejected": _ckpt_rejected_counter(registry),
        "requests": registry.counter(
            "serving_tier_routed_total",
            help="requests completed successfully through the router",
        ),
        "failovers": registry.counter(
            "serving_tier_failovers_total",
            help="request retries after a replica died mid-flight",
        ),
        "hedges": registry.counter(
            "serving_tier_hedges_total",
            help="request retries after a per-hop deadline on a "
                 "slow-but-alive replica (cancellation confirmed first)",
        ),
        "sheds": registry.counter(
            "serving_tier_sheds_total",
            help="requests shed because every replica was saturated",
        ),
        "hot_swaps": registry.counter(
            "serving_tier_hot_swaps_total",
            help="per-replica checkpoint hot-swaps applied by rolls",
        ),
        "roll_failures": registry.counter(
            "serving_tier_roll_failures_total",
            help="checkpoint rolls that failed (load error or drain timeout)",
        ),
        "deadline_expired": registry.counter(
            "serving_tier_deadline_expired_total",
            help="requests 504ed at the router when their budget ran out",
        ),
        "replicas_healthy": registry.gauge(
            "serving_tier_replicas_healthy",
            help="replicas currently in the healthy state",
        ),
        "latency": registry.histogram(
            "serving_tier_latency_seconds",
            help="end-to-end router latency (admission to final result, "
                 "failovers included)",
        ),
        "attempts": registry.histogram(
            "serving_tier_request_attempts",
            help="dispatch attempts per completed request (1 = no failover)",
            buckets=(1, 2, 3, 4, 5, 8),
        ),
    }


# ---------------------------------------------------------------- replicas


class LocalReplica:
    """An in-process :class:`~distkeras_tpu_torch.serving.engine.ServingEngine`
    behind the replica interface — what tests, bench, and the CI chaos
    smoke route over (deterministic, no sockets)."""

    def __init__(self, engine, name: str = ""):
        self.engine = engine
        self.name = name or f"local-{id(engine):x}"

    def probe(self, timeout: float = 1.0) -> Dict[str, float]:
        """Health + load snapshot; raises :class:`ReplicaDead` for a
        crashed engine, ``TimeoutError`` when the probe itself exceeds
        ``timeout`` (the chaos ``stall_http`` site lands here — a wedged
        ``/healthz`` must degrade the replica, not wedge the prober)."""
        t0 = time.perf_counter()
        if _chaos.enabled():
            _chaos.fault("http")
        if not self.engine.alive:
            raise ReplicaDead(f"replica {self.name}: engine crashed")
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(
                f"replica {self.name}: health probe exceeded {timeout}s")
        return self.engine.stats()

    def submit(self, request: GenerateRequest):
        return self.engine.submit(request)

    def cancel(self, handle) -> bool:
        """Cancel and *confirm*: returns ``True`` only once the handle has
        resolved — i.e. the engine provably stopped executing the request
        — which is what licenses an idempotent retry elsewhere."""
        self.engine.cancel(handle)
        return handle.result(timeout=5.0) is not None

    def hot_swap(self, model, params=None, timeout: float = 30.0) -> None:
        self.engine.hot_swap(model, params, timeout=timeout)

    def close(self) -> None:
        self.engine.stop()


class _HttpPending:
    """One in-flight HTTP generate call, result()-compatible with the
    engine's pending handle."""

    def __init__(self, url: str, payload: dict, timeout_s: Optional[float]):
        self._url = url
        self._payload = payload
        # socket deadline trails the propagated budget so the replica's own
        # 504 (its self-cancel acknowledgement) arrives before we give up
        self._timeout = (timeout_s + 2.0) if timeout_s else 30.0
        # trace context rides the hop as headers too, so even a replica
        # frontend that drops unknown body fields keeps the correlation;
        # X-DK-Parent-Span names the router-side span the replica's
        # serving.http_request span nests under in the merged trace
        self._headers = {"Content-Type": "application/json"}
        if payload.get("request_id"):
            self._headers["X-DK-Request-Id"] = payload["request_id"]
        if payload.get("trace_id"):
            self._headers["X-DK-Trace-Id"] = payload["trace_id"]
            self._headers["X-DK-Parent-Span"] = "tier.attempt"
        self._event = threading.Event()
        self._result: Optional[GenerateResult] = None
        self._error: Optional[Exception] = None
        self.got_504 = False
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        try:
            if _chaos.enabled():
                _chaos.fault("http")  # stall_http: wedge the outbound hop
            data = json.dumps(self._payload).encode("utf-8")
            req = urllib.request.Request(
                self._url, data=data, headers=self._headers)
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                body = resp.read().decode("utf-8", "replace")
            self._result = GenerateResult(**json.loads(body))
        except urllib.error.HTTPError as e:
            body = e.read().decode("utf-8", "replace")
            try:
                payload = json.loads(body)
            except ValueError:
                payload = {}
            if e.code == 504:
                # the replica hit its propagated deadline and self-cancelled
                self.got_504 = True
                self._error = TimeoutError(payload.get("error") or "hop 504")
            elif e.code == 503 and "finish_reason" in payload:
                self._result = GenerateResult(**payload)  # engine aborted
            elif e.code == 503:
                self._error = QueueFull(payload.get("error") or "replica 503")
            elif e.code == 400:
                self._error = ValueError(payload.get("error") or body)
            else:
                self._error = ConnectionError(f"HTTP {e.code}: {body[:200]}")
        except (OSError, ValueError, TypeError) as e:
            self._error = ConnectionError(f"{type(e).__name__}: {e}")
        finally:
            self._event.set()

    def result(self, timeout: Optional[float] = None):
        """The :class:`GenerateResult`, ``None`` on timeout *or* a
        replica-side 504 (both mean "no result, replica not executing it
        past its budget"); raises the transport error otherwise."""
        if not self._event.wait(timeout):
            return None
        if self._error is not None:
            if self.got_504:
                return None
            raise self._error
        return self._result


class HttpReplica:
    """A serving replica behind ``http://<address>/generate`` (its own
    flightdeck exporter).  When ``job`` (a daemon
    :class:`~distkeras_tpu_torch.job_deployment.Job` handle) is given, the probe
    consults the daemon first — a dead serve-job Popen (status
    ``failed``/``finished``) is :class:`ReplicaDead` *immediately*, no
    waiting for ``/healthz`` timeouts to burn the lease."""

    def __init__(self, address: str, name: str = "", job=None,
                 path: str = "/generate"):
        self.address = address
        self.name = name or address
        self.job = job
        self.path = path

    def probe(self, timeout: float = 1.0) -> Dict[str, float]:
        if self.job is not None:
            status = (self.job.status() or {}).get("status")
            if status in ("failed", "finished", "stopped"):
                raise ReplicaDead(
                    f"replica {self.name}: serve job is {status}")
        with urllib.request.urlopen(
                f"http://{self.address}/healthz", timeout=timeout) as resp:
            json.loads(resp.read().decode("utf-8", "replace"))
        with urllib.request.urlopen(
                f"http://{self.address}/vars", timeout=timeout) as resp:
            snap = json.loads(
                resp.read().decode("utf-8", "replace")).get("metrics", {})

        def _gauge(metric: str) -> float:
            return float((snap.get(metric) or {}).get("value") or 0.0)

        return {
            "queue_depth": _gauge("serving_queue_depth"),
            "active_slots": _gauge("serving_active_slots"),
        }

    def submit(self, request: GenerateRequest) -> _HttpPending:
        payload = dataclasses.asdict(request)
        return _HttpPending(
            f"http://{self.address}{self.path}", payload, request.timeout_s)

    def cancel(self, handle: _HttpPending) -> bool:
        """There is no out-of-band abort over HTTP; idempotency rides the
        propagated deadline instead — only a replica-side 504 (it already
        self-cancelled) confirms the replica stopped executing."""
        return handle.got_504

    def hot_swap(self, model, params=None, timeout: float = 30.0) -> None:
        raise NotImplementedError(
            "HTTP replicas hot-swap autonomously via watch_and_swap() in "
            "their serve script, not through the router")

    def close(self) -> None:
        pass


class _Entry:
    """Router-side record for one replica."""

    __slots__ = ("replica", "name", "index", "wid", "state", "failures",
                 "stats", "inflight", "last_error")

    def __init__(self, replica, index: int):
        self.replica = replica
        self.name = replica.name
        self.index = index
        self.wid = f"{index}:{self.name}"
        self.state = "starting"
        self.failures = 0
        self.stats: Dict[str, float] = {}
        self.inflight = 0
        self.last_error: Optional[str] = None

    def load(self) -> float:
        return (float(self.stats.get("queue_depth") or 0.0)
                + float(self.stats.get("active_slots") or 0.0)
                + float(self.inflight))


# ------------------------------------------------------------------ router


class ServingTier:
    """The request router.  ``replicas`` may mix :class:`LocalReplica`,
    :class:`HttpReplica`, and raw ``ServingEngine`` instances (wrapped
    automatically).  Probing runs from a daemon thread after
    :meth:`start`; without it, the first dispatch runs one synchronous
    probe round so a freshly built tier is usable in tests."""

    def __init__(self, replicas: Sequence, *,
                 probe_interval: float = 0.2,
                 probe_timeout: float = 1.0,
                 probe_misses: int = 3,
                 max_attempts: int = 3,
                 default_deadline_s: float = 30.0,
                 hop_timeout_s: Optional[float] = None,
                 backoff_s: float = 0.02,
                 backoff_cap_s: float = 0.25,
                 registry=None,
                 slo_objectives: Optional[Sequence] = None,
                 traffic_log=None,
                 clock: Callable[[], float] = time.monotonic):
        if not replicas:
            raise ValueError("a serving tier needs at least one replica")
        wrapped = []
        for i, rep in enumerate(replicas):
            if not hasattr(rep, "probe"):
                rep = LocalReplica(rep, name=f"replica-{i}")
            wrapped.append(rep)
        self._entries = [_Entry(rep, i) for i, rep in enumerate(wrapped)]
        self.probe_interval = float(probe_interval)
        self.probe_timeout = float(probe_timeout)
        self.max_attempts = int(max_attempts)
        self.default_deadline_s = float(default_deadline_s)
        self.hop_timeout_s = hop_timeout_s
        self.backoff_s = float(backoff_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._clock = clock
        self._metrics = tier_metrics(registry)
        self._registry = registry
        # per-tenant accounting (None when DISTKERAS_ACCOUNTING is off):
        # the router bills each request exactly once at completion —
        # failed failover attempts fold into that one bill, never counted
        # per attempt
        self._acct = _accounting.maybe_ledger(registry)
        # router-level online capture (satellite of the accounting plane):
        # the tenant is resolved once here and inherited by capture and
        # accounting alike, so a replica frontend no longer has to carry
        # its own hook to close the serve->train loop
        self._traffic_log = traffic_log
        # replica liveness rides the fleet lease machinery: a successful
        # probe is a heartbeat; a replica that misses probe_misses probes'
        # worth of lease is swept exactly like a preempted trainer
        self._membership = FleetMembership(
            lease=self.probe_interval + self.probe_timeout,
            miss_tolerance=int(probe_misses), clock=clock)
        self._cv = lockwatch.maybe_wrap(
            threading.Condition(), "serving.tier")
        self._probed = False
        self._stop_evt: Optional[threading.Event] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._watchers: List[Tuple[threading.Event, threading.Thread]] = []
        # SLO evaluation rides the probe loop; None until start() and only
        # ever non-None when telemetry + DISTKERAS_ROLLUP are on, so the
        # flag-off dispatch/probe path is untouched.
        self._slo_objectives = slo_objectives
        self._slo = None

    # ----------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Run one synchronous probe round (the tier is dispatchable on
        return), then keep probing from a daemon thread."""
        self.probe_once()
        with self._cv:
            if self._probe_thread is not None:
                return
            self._stop_evt = threading.Event()
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="serving-tier-probe",
                daemon=True)
            self._probe_thread.start()
        if self._slo is None:
            from distkeras_tpu_torch.telemetry import slo as _slo

            objectives = self._slo_objectives
            if objectives is None:
                objectives = _slo.default_serving_objectives()
            self._slo = _slo.maybe_engine(
                objectives, source="serving_tier", registry=self._registry)

    def stop(self, close_replicas: bool = False) -> None:
        """Stop the prober and any checkpoint watchers; optionally stop
        the replicas themselves (in-process engines)."""
        with self._cv:
            stop_evt, self._stop_evt = self._stop_evt, None
            thread, self._probe_thread = self._probe_thread, None
            watchers, self._watchers = list(self._watchers), []
        if stop_evt is not None:
            stop_evt.set()
        for evt, _t in watchers:
            evt.set()
        if thread is not None:
            thread.join(timeout=5)
        for _evt, t in watchers:
            t.join(timeout=5)
        if close_replicas:
            for entry in self._entries:
                entry.replica.close()

    def _probe_loop(self) -> None:
        stop = self._stop_evt
        while stop is not None and not stop.wait(self.probe_interval):
            try:
                self.probe_once()
                if self._slo is not None:
                    self._slo.evaluate()
            except Exception:  # noqa: BLE001 — a failed sweep/export must
                # not kill the supervisor; the next round retries it
                continue

    # ------------------------------------------------------------- probing

    def probe_once(self) -> None:
        """One probe round over every replica + a lease sweep."""
        for entry in self._entries:
            self._probe_entry(entry)
        with self._cv:
            evicted = set(self._membership.sweep())
            for entry in self._entries:
                if entry.wid in evicted and entry.state != "dead":
                    entry.state = "dead"
            self._probed = True
        self._export_health()

    def _probe_entry(self, entry: _Entry) -> None:
        try:
            info = entry.replica.probe(timeout=self.probe_timeout)
        except ReplicaDead as e:
            with self._cv:
                entry.failures += 1
                entry.last_error = str(e)
                if entry.state != "dead":
                    entry.state = "dead"
                    self._membership.deregister(entry.wid)
            return
        except Exception as e:  # noqa: BLE001 — any probe failure degrades
            with self._cv:
                entry.failures += 1
                entry.last_error = str(e)
                if entry.state == "healthy":
                    entry.state = "degraded"
                # no heartbeat: the lease keeps draining toward eviction
            return
        with self._cv:
            entry.failures = 0
            entry.stats = dict(info or {})
            entry.last_error = None
            if not self._membership.heartbeat(entry.wid):
                # first probe, or a rejoin after eviction (epoch bumps)
                self._membership.register(
                    entry.wid, host=entry.name,
                    meta={"role": "serving", "index": entry.index})
            if entry.state in ("starting", "degraded", "dead"):
                entry.state = "healthy"

    def _export_health(self) -> None:
        if self._registry is None:
            from distkeras_tpu_torch.telemetry.metrics import metrics as registry
        else:
            registry = self._registry
        with self._cv:
            states = [(e.index, e.state) for e in self._entries]
        healthy = sum(1 for _i, s in states if s == "healthy")
        self._metrics["replicas_healthy"].set(healthy)
        for index, state in states:
            registry.gauge(
                f"serving_tier_replica_health_{index}",
                help="replica health ordinal (0=starting 1=healthy "
                     "2=degraded 3=draining 4=dead)",
            ).set(REPLICA_STATES.index(state))

    def _mark_dead(self, entry: _Entry, why: str) -> None:
        with self._cv:
            entry.last_error = why
            if entry.state != "dead":
                entry.state = "dead"
                self._membership.deregister(entry.wid)
        self._export_health()

    # ------------------------------------------------------------ dispatch

    def _pick(self, exclude: Dict[str, str]) -> Optional[_Entry]:
        with self._cv:
            probed = self._probed
        if not probed:
            self.probe_once()
        with self._cv:
            pools: Dict[str, List[_Entry]] = {"healthy": [], "degraded": []}
            for entry in self._entries:
                if entry.name in exclude or entry.state not in pools:
                    continue
                pools[entry.state].append(entry)
            for state in ("healthy", "degraded"):
                if pools[state]:
                    return min(pools[state],
                               key=lambda e: (e.load(), e.index))
        return None

    def _backoff(self, attempt: int, deadline: float) -> None:
        delay = min(self.backoff_cap_s,
                    self.backoff_s * (2 ** max(0, attempt - 1)))
        delay *= 0.5 + 0.5 * random.random()  # jitter against retry storms
        delay = min(delay, max(0.0, deadline - self._clock()))
        if delay > 0:
            time.sleep(delay)

    def generate(self, prompt=None, request: Optional[GenerateRequest] = None,
                 deadline_s: Optional[float] = None,
                 **knobs) -> GenerateResult:
        """Route one request.  Pass a ``prompt`` (+ sampling ``knobs``) or
        a prebuilt ``request``.  Raises :class:`TierDeadline` (budget ran
        out), :class:`TierSaturated` (shed), or :class:`TierExhausted`
        (attempt cap)."""
        if request is None:
            if prompt is None:
                raise ValueError("need a prompt or a GenerateRequest")
            request = GenerateRequest(
                prompt=[int(t) for t in prompt], **knobs)
        return self.dispatch(request, deadline_s=deadline_s)

    def dispatch(self, request: GenerateRequest,
                 deadline_s: Optional[float] = None) -> GenerateResult:
        budget = (deadline_s if deadline_s is not None
                  else (request.timeout_s or self.default_deadline_s))
        deadline = self._clock() + float(budget)
        if not request.request_id:
            # the idempotency key: every hop of this request carries the
            # same id, so replica-side logs/metrics can correlate retries
            request = dataclasses.replace(
                request, request_id=uuid.uuid4().hex)
        if not request.trace_id:
            # the correlation key: unlike request_id it is never used for
            # idempotency decisions, only to join spans across processes
            request = dataclasses.replace(request, trace_id=new_trace_id())
        root = NOOP_SPAN
        if _truntime.enabled():
            attrs = dict(request_id=request.request_id,
                         trace_id=request.trace_id,
                         budget_s=round(float(budget), 3))
            if request.tenant:
                attrs["tenant"] = request.tenant
            root = _trace.span("tier.request", **attrs)
        with _trace.bind(trace_id=request.trace_id,
                         request_id=request.request_id), root:
            try:
                result = self._dispatch(request, budget, deadline)
            except TierError as e:
                _span_note(root, outcome=type(e).__name__)
                raise
            _span_note(root, outcome="ok")
            return result

    def _dispatch(self, request: GenerateRequest, budget: float,
                  deadline: float) -> GenerateResult:
        t0 = time.perf_counter()
        attempts = 0
        # replicas excluded for the rest of THIS request: saturated, or
        # possibly still executing an uncancelled earlier hop
        exclude: Dict[str, str] = {}
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                self._metrics["deadline_expired"].inc()
                raise TierDeadline(
                    f"deadline ({budget}s) exhausted after "
                    f"{attempts} attempt(s)")
            if attempts >= self.max_attempts:
                raise TierExhausted(
                    f"request failed after {attempts} attempts "
                    f"(cap {self.max_attempts})")
            entry = self._pick(exclude)
            if entry is None:
                self._metrics["sheds"].inc()
                raise TierSaturated(
                    "no dispatchable replica (all saturated, excluded, "
                    "or unhealthy)")
            hop = (remaining if self.hop_timeout_s is None
                   else min(remaining, self.hop_timeout_s))
            # deadline propagation: the replica gets the hop budget, not
            # its own independent timeout — over HTTP its handler 504s
            # (and self-cancels) exactly when the router stops waiting
            hop_request = dataclasses.replace(request, timeout_s=hop)
            attempts += 1
            # the attempt span stack-nests under tier.request (same
            # thread); its outcome arg is what dktrace critical-path
            # renders as the per-attempt verdict
            aspan = NOOP_SPAN
            if _truntime.enabled():
                aspan = _trace.span(
                    "tier.attempt", attempt=attempts, replica=entry.name,
                    hop_s=round(float(hop), 3))
            with aspan:
                try:
                    handle = entry.replica.submit(hop_request)
                except QueueFull:
                    _span_note(aspan, outcome="saturated")
                    exclude[entry.name] = "saturated"
                    attempts -= 1  # saturation is a shed decision, not a hop
                    continue
                except (EngineCrashed, ReplicaDead, ConnectionError,
                        OSError) as e:
                    _span_note(aspan, outcome="dead_on_submit")
                    self._mark_dead(entry, f"submit failed: {e}")
                    self._metrics["failovers"].inc()
                    self._backoff(attempts, deadline)
                    continue
                with self._cv:
                    entry.inflight += 1
                try:
                    try:
                        result = handle.result(timeout=hop)
                    except QueueFull:  # HTTP replicas surface 503 at result
                        _span_note(aspan, outcome="saturated")
                        exclude[entry.name] = "saturated"
                        attempts -= 1
                        continue
                    except (ConnectionError, OSError) as e:
                        _span_note(aspan, outcome="transport_error")
                        self._probe_entry(entry)  # dead or flaky? decide now
                        self._export_health()
                        self._metrics["failovers"].inc()
                        entry.last_error = str(e)
                        self._backoff(attempts, deadline)
                        continue
                finally:
                    with self._cv:
                        entry.inflight -= 1
                if result is None:
                    # slow hop: hedge — but only once the replica provably
                    # stopped executing (confirmed cancel / replica-side 504)
                    confirmed = entry.replica.cancel(handle)
                    if confirmed:
                        late = handle.result(timeout=0)
                        if late is not None and late.finish_reason != "aborted":
                            result = late  # finished inside the cancel window
                        else:
                            _span_note(aspan, outcome="hedge")
                            self._metrics["hedges"].inc()
                            self._backoff(attempts, deadline)
                            continue
                    else:
                        _span_note(aspan, outcome="hedge_uncancelled")
                        exclude[entry.name] = "uncancelled"
                        self._metrics["hedges"].inc()
                        self._backoff(attempts, deadline)
                        continue
                if result.finish_reason == "aborted":
                    # the replica stopped/crashed with the request in flight
                    # — THE failover case; re-probe so routing reacts now
                    _span_note(aspan, outcome="aborted_failover")
                    self._probe_entry(entry)
                    self._export_health()
                    self._metrics["failovers"].inc()
                    self._backoff(attempts, deadline)
                    continue
                _span_note(aspan, outcome="ok")
                latency = time.perf_counter() - t0
                self._metrics["latency"].observe(latency)
                self._metrics["attempts"].observe(attempts)
                self._metrics["requests"].inc()
                if self._acct is not None:
                    self._acct.request(request.tenant, attempts=attempts,
                                       latency_s=latency)
                self._offer_capture(request, result)
                return result

    # ------------------------------------------------------ online capture

    def attach_traffic_log(self, traffic_log) -> None:
        """Attach (or replace) the router-level capture hook after
        construction — what :func:`install_tier_endpoint` uses when handed
        a ``traffic_log``."""
        self._traffic_log = traffic_log

    def _offer_capture(self, request: GenerateRequest, result) -> None:
        """Offer a completed generation to the capture ring.  Strictly
        best-effort: a capture fault is counted and swallowed, never
        surfaced to the caller — routing must not fail because capture
        did (same contract as the frontend hook)."""
        log = self._traffic_log
        if log is None:
            return
        try:
            log.record(request, result)
        except Exception:  # noqa: BLE001 — capture is best-effort
            from distkeras_tpu_torch import telemetry

            if telemetry.enabled():
                from distkeras_tpu_torch.online.capture import online_metrics

                online_metrics()["capture_errors"].inc()

    # ----------------------------------------------------- rolling hot-swap

    def roll(self, model, params=None, *, timeout: float = 60.0) -> int:
        """Hot-swap every live replica to ``(model, params)``, strictly one
        at a time: mark it draining (the router stops dispatching to it),
        let the engine drain its slots and swap in place (zero dropped
        requests), then wait until it probes healthy again before touching
        the next — so ≥1 replica stays dispatchable throughout.  Returns
        the number of replicas swapped."""
        swapped = 0
        for entry in self._entries:
            with self._cv:
                if entry.state == "dead":
                    continue
                entry.state = "draining"
            self._export_health()
            try:
                entry.replica.hot_swap(model, params, timeout=timeout)
            except Exception as e:
                self._metrics["roll_failures"].inc()
                with self._cv:
                    entry.state = "starting"
                raise TierError(
                    f"roll failed at replica {entry.name}: {e}") from e
            self._metrics["hot_swaps"].inc()
            with self._cv:
                entry.state = "starting"
            if not self._await_healthy(entry, timeout):
                self._metrics["roll_failures"].inc()
                raise TierError(
                    f"replica {entry.name} did not return to healthy "
                    f"within {timeout}s after its swap")
            swapped += 1
        return swapped

    def _await_healthy(self, entry: _Entry, timeout: float) -> bool:
        deadline = self._clock() + timeout
        while True:
            self._probe_entry(entry)
            self._export_health()
            with self._cv:
                if entry.state == "healthy":
                    return True
            if self._clock() >= deadline:
                return False
            time.sleep(0.01)

    def watch_checkpoints(self, directory: str, loader,
                          poll_interval: float = 0.25) -> threading.Thread:
        """Roll the fleet whenever a newer checkpoint commits in
        ``directory``.  ``loader(step) -> (model, params)`` materializes
        the params (e.g. ``restore_center``).  The watcher only surfaces
        published steps that pass a fast size check, and each surfaced
        step is re-verified against its manifest digests *at swap time* —
        a step whose bytes rotted between publish and swap is rejected
        (``serving_checkpoint_rejected_total``) with the fleet untouched:
        old params keep serving, no request is dropped.  Watching stops
        with :meth:`stop`."""
        from distkeras_tpu_torch.checkpoint import CheckpointWatcher, verify_failure

        watcher = CheckpointWatcher(directory)
        stop = threading.Event()

        def _watch():
            while not stop.wait(poll_interval):
                try:
                    step = watcher.poll()
                    if step is None:
                        continue
                    if verify_failure(directory, step, "full") is not None:
                        self._metrics["ckpt_rejected"].inc()
                        continue
                    try:
                        model, params = loader(step)
                        self.roll(model, params)
                    except Exception:  # noqa: BLE001 — a bad checkpoint
                        # must not kill the watcher; counted separately
                        self._metrics["roll_failures"].inc()
                except Exception:  # noqa: BLE001 — a transient poll/verify
                    # error (fs flake, torn manifest) must not kill the
                    # watcher either; the next round re-polls
                    continue

        thread = threading.Thread(
            target=_watch, name="serving-tier-ckpt-watch", daemon=True)
        thread.start()
        with self._cv:
            self._watchers.append((stop, thread))
        return thread

    # ---------------------------------------------------------- inspection

    def states(self) -> Dict[str, str]:
        with self._cv:
            return {e.name: e.state for e in self._entries}

    def snapshot(self) -> dict:
        """JSON-safe health/load view (the ``/tier`` endpoint and the
        daemon's ``tier_status`` verb)."""
        with self._cv:
            membership = self._membership.snapshot()
            replicas = [{
                "name": e.name,
                "index": e.index,
                "state": e.state,
                "load": e.load(),
                "queue_depth": float(e.stats.get("queue_depth") or 0.0),
                "active_slots": float(e.stats.get("active_slots") or 0.0),
                "inflight": e.inflight,
                "failures": e.failures,
                "last_error": e.last_error,
            } for e in self._entries]
        return {
            "replicas": replicas,
            "healthy": sum(1 for r in replicas if r["state"] == "healthy"),
            "epoch": membership["epoch"],
            "evictions": membership["evictions"],
        }


# --------------------------------------------------- replica-side hot-swap


def watch_and_swap(engine, directory: str, loader,
                   poll_interval: float = 0.25):
    """Autonomous per-replica hot-swap: poll ``directory`` for newly
    published checkpoints and ``engine.hot_swap`` to each — how an HTTP
    replica's serve script tracks the trainer without router involvement
    (the router only gates health around the swap's drain).  Each step is
    re-verified against its manifest digests right before the swap; a
    failing one is rejected (``serving_checkpoint_rejected_total``) and
    the engine keeps its current params.  Returns a zero-arg stopper."""
    from distkeras_tpu_torch.checkpoint import CheckpointWatcher, verify_failure

    watcher = CheckpointWatcher(directory)
    stop = threading.Event()

    def _watch():
        while not stop.wait(poll_interval):
            try:
                step = watcher.poll()
                if step is None:
                    continue
                if verify_failure(directory, step, "full") is not None:
                    _ckpt_rejected_counter().inc()
                    continue
                model, params = loader(step)
                engine.hot_swap(model, params)
            except Exception:  # noqa: BLE001 — keep watching; a transient
                # poll/verify error is retried next round
                continue

    thread = threading.Thread(
        target=_watch, name="serving-replica-ckpt-watch", daemon=True)
    thread.start()

    def stopper():
        stop.set()
        thread.join(timeout=5)

    return stopper


# ---------------------------------------------------------------- endpoint


def install_tier_endpoint(tier: ServingTier, path: str = "/generate",
                          status_path: str = "/tier",
                          traffic_log=None) -> str:
    """Mount the router on the flightdeck exporter: ``path`` routes
    requests across the tier (maps :class:`TierSaturated` → 503 +
    ``Retry-After``, :class:`TierDeadline` → 504, :class:`TierExhausted`
    → 502), ``status_path`` serves the health snapshot.  ``traffic_log``
    attaches router-level online capture — the preferred hook point, so
    tenant resolution, accounting, and capture all happen once at the
    router instead of per replica frontend.  Returns the mounted path."""
    from distkeras_tpu_torch.serving.frontend import _parse_request
    from distkeras_tpu_torch.telemetry.flightdeck import server as _server

    if traffic_log is not None:
        tier.attach_traffic_log(traffic_log)

    def handle(request):
        try:
            req = _parse_request(request)
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            body = json.dumps({"error": f"{type(e).__name__}: {e}"})
            return ("application/json", body, 400)
        try:
            result = tier.dispatch(req)
        except TierSaturated as e:
            return ("application/json", json.dumps({"error": str(e)}), 503,
                    {"Retry-After": "1"})
        except TierDeadline as e:
            return ("application/json", json.dumps({"error": str(e)}), 504)
        except TierExhausted as e:
            return ("application/json", json.dumps({"error": str(e)}), 502)
        except ValueError as e:
            return ("application/json", json.dumps({"error": str(e)}), 400)
        return ("application/json", result.to_json(), 200)

    _server.add_endpoint(path, handle)
    _server.add_endpoint(
        status_path,
        lambda: ("application/json", json.dumps(tier.snapshot())))
    return path
