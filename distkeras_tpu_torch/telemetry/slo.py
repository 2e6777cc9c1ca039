"""SLO engine: declarative objectives, burn-rate alerting, incident log —
the port of :mod:`distkeras_tpu.telemetry.slo` (host code, copied).

The rollup ring (:mod:`.flightdeck.rollup`) holds windowed history; this
module turns it into *decisions*.  An :class:`SLOConfig` states an objective
over one of three signal shapes:

* ``"quantile"`` — a latency histogram must keep ``target`` of its
  observations under ``threshold`` (``serving_ttft_seconds p99 < 250ms`` is
  ``quantile=0.99, threshold=0.25, target=0.99``);
* ``"gauge"`` — a gauge must stay on the right side of ``threshold``
  (``online_window_lag_seconds < 2×window``, or ``op="lt"`` for
  ``serving_tier_replicas_healthy >= 1``);
* ``"ratio"`` — a bad-event counter must stay under ``1 - target`` of a
  total-event counter (shed ratio, error ratio).

Each objective is evaluated as a **burn rate**: the observed bad fraction
divided by the error budget (``1 - target``).  Burn 1.0 means the budget is
being spent exactly as fast as it accrues; burn 10 means ten times too
fast.  Alerts use the Prometheus multi-window recipe — fire only when BOTH
a fast window (reactive, noisy) and a slow window (confirming, stable)
burn at or above ``burn_threshold``; resolve when the fast window drops
back under it.  Fire/resolve transitions append one JSON line each to an
**incident log** (single ``O_APPEND`` write per record, so concurrent
engines interleave whole lines), stamped with the fleet ``run_id`` and the
worst-offending ``trace_id``s still in the flight-recorder ring — the
operator jumps straight from the page to ``dktrace critical-path``.

Evaluation is wired into loops that already exist (the serving tier's probe
loop and the window scheduler's poll loop, which come with ROADMAP Queue A
item 18; any caller's loop meanwhile) via :func:`maybe_engine`, which
returns ``None`` unless telemetry *and* ``DISTKERAS_ROLLUP`` are on — the
flag-off path stays untouched.  ``tools.dkmon`` and the Punchcard daemon's
``slo_status`` verb consume the ``/slo`` endpoint this module installs (the
daemon adds its own process's engines).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from distkeras_tpu_torch.telemetry import runtime as _runtime
from distkeras_tpu_torch.telemetry.flightdeck import correlate as _correlate
from distkeras_tpu_torch.telemetry.flightdeck import rollup as _rollup
from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder as _recorder

__all__ = [
    "SLOConfig",
    "SLOEngine",
    "breach_fraction_from_cumulative",
    "default_online_objectives",
    "default_serving_objectives",
    "engines",
    "incident_path",
    "install_slo_endpoint",
    "maybe_engine",
    "reset_engines",
    "slo_metrics",
    "slo_view",
    "worst_trace_ids",
]

KINDS = ("quantile", "gauge", "ratio")


@dataclass(frozen=True)
class SLOConfig:
    """One declarative objective; see module docstring for the kinds."""

    name: str
    kind: str
    metric: str = ""
    quantile: float = 0.99
    threshold: float = 0.0
    op: str = "gt"
    bad_metric: str = ""
    total_metric: Union[str, Sequence[str]] = ""
    target: float = 0.99
    fast_window_s: float = 30.0
    slow_window_s: float = 120.0
    burn_threshold: float = 2.0
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.kind in ("quantile", "gauge") and not self.metric:
            raise ValueError(f"objective {self.name!r} needs a metric")
        if self.kind == "ratio" and not (self.bad_metric and self.total_metric):
            raise ValueError(
                f"objective {self.name!r} needs bad_metric and total_metric")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"objective {self.name!r}: fast window must be shorter "
                f"than slow window")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def breach_fraction_from_cumulative(buckets: Dict[str, float],
                                    threshold: float) -> float:
    """Fraction of observations above ``threshold``, from cumulative
    ``{le: count}`` buckets.  Exact when the threshold sits on a bucket
    boundary; linear within a bucket otherwise.  Observations in the +Inf
    overflow count as breaching any finite threshold at or above the top
    finite bound (the conservative reading of a bounded ladder)."""
    from distkeras_tpu_torch.telemetry.metrics import _le_key

    ladder = sorted(((_le_key(le), n) for le, n in buckets.items()))
    total = ladder[-1][1] if ladder else 0
    if total <= 0:
        return 0.0
    prev_bound, prev_cum = 0.0, 0
    cum_at = None
    for bound, cum in ladder:
        if math.isinf(bound):
            continue
        if threshold <= bound:
            if threshold == bound:
                cum_at = cum
            elif bound == prev_bound:
                cum_at = cum
            else:
                frac = max(0.0, (threshold - prev_bound) / (bound - prev_bound))
                cum_at = prev_cum + frac * (cum - prev_cum)
            break
        prev_bound, prev_cum = bound, cum
    if cum_at is None:
        # Threshold above the top finite bound: only +Inf overflow breaches.
        cum_at = prev_cum
    return max(0.0, 1.0 - cum_at / total)


def worst_trace_ids(limit: int = 3) -> List[str]:
    """Trace ids of the longest spans still in the flight-recorder ring —
    the "worst offenders" stamped into incident records."""
    best: Dict[str, float] = {}
    for e in _recorder.events():
        if e.get("kind") != "span":
            continue
        event = e.get("event") or {}
        args = event.get("args") or {}
        dur = float(event.get("dur") or 0.0)
        tids = []
        if args.get("trace_id"):
            tids.append(args["trace_id"])
        tids.extend(args.get("trace_ids") or ())
        for tid in tids:
            if dur >= best.get(tid, -1.0):
                best[tid] = dur
    ranked = sorted(best.items(), key=lambda kv: kv[1], reverse=True)
    return [tid for tid, _ in ranked[:limit]]


def incident_path() -> str:
    """Where incident records land: ``DISTKERAS_SLO_INCIDENTS`` when set,
    else ``incidents_<run_id>.jsonl`` in the telemetry directory."""
    explicit = os.environ.get("DISTKERAS_SLO_INCIDENTS")
    if explicit:
        return explicit
    rid = _correlate.current() or f"pid{os.getpid()}"
    return os.path.join(_runtime.out_dir(), f"incidents_{rid}.jsonl")


def slo_metrics(registry=None) -> dict:
    """Get-or-create the engine's instruments (default: process-global
    registry).  One canonical home for names/help so the engine, the golden
    test, and the CI dkmon smoke assert the same schema."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return {
        "objectives": registry.gauge(
            "slo_objectives",
            help="SLO objectives registered across live engines",
        ),
        "evaluations": registry.counter(
            "slo_evaluations_total",
            help="SLO evaluation passes across live engines",
        ),
        "burning": registry.gauge(
            "slo_burning",
            help="objectives whose fast-window burn rate is at or above "
                 "their alert threshold",
        ),
        "burn_max": registry.gauge(
            "slo_burn_rate_max",
            help="worst fast-window burn rate across objectives "
                 "(1.0 = error budget spent exactly as fast as it accrues)",
        ),
        "firing": registry.gauge(
            "alert_firing",
            help="alerts currently firing (fast AND slow windows over "
                 "their burn threshold)",
        ),
        "fired": registry.counter(
            "alert_fired_total",
            help="alert fire transitions",
        ),
        "resolved": registry.counter(
            "alert_resolved_total",
            help="alert resolve transitions",
        ),
        "incidents": registry.counter(
            "alert_incidents_total",
            help="incident log records appended (fire + resolve lines)",
        ),
    }


class SLOEngine:
    """Evaluates a set of objectives against a rollup ring.

    One engine per subsystem (``source`` names it: "serving_tier",
    "online"); all engines in a process share the global rollup ring, the
    canonical ``slo_*``/``alert_*`` instruments, and the ``/slo`` endpoint.
    ``evaluate()`` is called from the owner's existing loop — it reads ring
    snapshots and writes at most two incident lines per objective per
    transition, so it is safe at probe-loop cadence.
    """

    def __init__(self, objectives: Sequence[SLOConfig], source: str = "slo",
                 ring: Optional[_rollup.RollupRing] = None, registry=None,
                 clock=time.time, incident_file: Optional[str] = None):
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.objectives = tuple(objectives)
        self.source = source
        self._ring = ring
        self._registry = registry
        self.clock = clock
        self._incident_file = incident_file
        self._lock = threading.Lock()
        self._state = {
            o.name: {"firing": False, "since": None} for o in objectives
        }
        self._last: Optional[dict] = None

    @property
    def ring(self) -> Optional[_rollup.RollupRing]:
        return self._ring if self._ring is not None else _rollup.rollup_ring()

    def _metrics(self) -> dict:
        return slo_metrics(self._registry)

    # ------------------------------------------------------------ evaluation

    def _bad_fraction(self, o: SLOConfig, window_s: float, now: float,
                      ring: _rollup.RollupRing) -> Optional[float]:
        """Observed bad fraction over one window; ``None`` = not enough
        ring history to tell (distinct from a measured 0.0)."""
        if o.kind == "quantile":
            delta = ring.window_delta(o.metric, window_s, now)
            if delta is None:
                return None
            if delta["count"] == 0:
                return 0.0  # no traffic spends no budget
            return breach_fraction_from_cumulative(delta["buckets"],
                                                   o.threshold)
        if o.kind == "gauge":
            return ring.window_breach_fraction(o.metric, o.threshold,
                                               window_s, now, op=o.op)
        bad = ring.window_rate(o.bad_metric, window_s, now)
        totals = ([o.total_metric] if isinstance(o.total_metric, str)
                  else list(o.total_metric))
        rates = [ring.window_rate(m, window_s, now) for m in totals]
        if bad is None or any(r is None for r in rates):
            return None
        total = sum(rates)
        if total <= 0:
            return 0.0
        return min(1.0, bad / total)

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: burn rates, alert transitions, incidents.
        Returns (and caches) the status dict the ``/slo`` endpoint serves."""
        ring = self.ring
        now = self.clock() if now is None else float(now)
        inst = self._metrics()
        if ring is None:
            status = {"source": self.source, "enabled": False, "unix": now,
                      "objectives": []}
            with self._lock:
                self._last = status
            return status
        rows = []
        with self._lock:
            for o in self.objectives:
                bad_fast = self._bad_fraction(o, o.fast_window_s, now, ring)
                bad_slow = self._bad_fraction(o, o.slow_window_s, now, ring)
                burn_fast = None if bad_fast is None else bad_fast / o.budget
                burn_slow = None if bad_slow is None else bad_slow / o.budget
                observed = None
                if o.kind == "quantile":
                    observed = ring.window_quantile(
                        o.metric, o.quantile, o.fast_window_s, now)
                state = self._state[o.name]
                should_fire = (
                    burn_fast is not None and burn_slow is not None
                    and burn_fast >= o.burn_threshold
                    and burn_slow >= o.burn_threshold
                )
                should_resolve = (
                    state["firing"]
                    and (burn_fast or 0.0) < o.burn_threshold
                )
                if should_fire and not state["firing"]:
                    state["firing"], state["since"] = True, now
                    inst["fired"].inc()
                    self._incident("fire", o, now, burn_fast, burn_slow,
                                   observed, inst)
                elif should_resolve:
                    state["firing"], state["since"] = False, None
                    inst["resolved"].inc()
                    self._incident("resolve", o, now, burn_fast, burn_slow,
                                   observed, inst)
                rows.append({
                    "name": o.name,
                    "kind": o.kind,
                    "metric": o.metric or o.bad_metric,
                    "threshold": o.threshold,
                    "target": o.target,
                    "burn_threshold": o.burn_threshold,
                    "bad_fast": bad_fast,
                    "bad_slow": bad_slow,
                    "burn_fast": burn_fast,
                    "burn_slow": burn_slow,
                    "observed": observed,
                    "firing": state["firing"],
                    "since": state["since"],
                    "description": o.description,
                })
            status = {"source": self.source, "enabled": True, "unix": now,
                      "objectives": rows}
            self._last = status
        inst["evaluations"].inc()
        _update_fleet_gauges(inst)
        return status

    def status(self) -> dict:
        """Last evaluation result (an empty shell before the first pass)."""
        with self._lock:
            if self._last is not None:
                return self._last
        return {"source": self.source, "enabled": self.ring is not None,
                "unix": None, "objectives": []}

    # -------------------------------------------------------------- incidents

    def _incident(self, event: str, o: SLOConfig, now: float,
                  burn_fast, burn_slow, observed, inst) -> None:
        record = {
            "event": event,
            "objective": o.name,
            "source": self.source,
            "unix": now,
            "run_id": _correlate.current(),
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "burn_threshold": o.burn_threshold,
            "threshold": o.threshold,
            "observed": observed,
            "trace_ids": worst_trace_ids(),
        }
        path = self._incident_file or incident_path()
        line = (json.dumps(record) + "\n").encode("utf-8")
        # One O_APPEND write per record: whole lines interleave atomically
        # even when several engines (or processes) share the log.
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            return  # forensics must never take down the serving path
        inst["incidents"].inc()


# ------------------------------------------------- process-global engine set

_ENGINES: Dict[str, SLOEngine] = {}
_ENGINES_LOCK = threading.Lock()
_ENDPOINT_INSTALLED = False


def engines() -> Dict[str, SLOEngine]:
    with _ENGINES_LOCK:
        return dict(_ENGINES)


def reset_engines() -> None:
    """Drop registered engines (tests and daemon teardown)."""
    with _ENGINES_LOCK:
        _ENGINES.clear()


def maybe_engine(objectives: Sequence[SLOConfig], source: str,
                 **kwargs) -> Optional[SLOEngine]:
    """Build, register, and expose an engine — or ``None`` when telemetry
    or rollups are off.  The one call subsystem loops make; the ``None``
    return keeps their flag-off path untouched."""
    if not _runtime.enabled():
        return None
    if _rollup.ensure_rollup() is None and kwargs.get("ring") is None:
        return None
    engine = SLOEngine(objectives, source=source, **kwargs)
    with _ENGINES_LOCK:
        _ENGINES[source] = engine
    install_slo_endpoint()
    return engine


def _update_fleet_gauges(inst: dict) -> None:
    """Recompute the cross-engine ``slo_*``/``alert_*`` gauges from every
    registered engine's last status."""
    total = burning = firing = 0
    burn_max = 0.0
    for engine in engines().values():
        for row in engine.status().get("objectives", ()):
            total += 1
            burn = row.get("burn_fast")
            if burn is not None:
                burn_max = max(burn_max, burn)
                if burn >= row["burn_threshold"]:
                    burning += 1
            if row.get("firing"):
                firing += 1
    inst["objectives"].set(total)
    inst["burning"].set(burning)
    inst["burn_max"].set(burn_max)
    inst["firing"].set(firing)


def slo_view(request: Optional[dict] = None):
    """``/slo`` endpoint body: every registered engine's last status."""
    snapshot = {src: e.status() for src, e in sorted(engines().items())}
    body = {
        "enabled": bool(snapshot),
        "run_id": _correlate.current(),
        "unix": time.time(),
        "incident_log": incident_path(),
        "engines": snapshot,
    }
    return ("application/json", json.dumps(body), 200)


def install_slo_endpoint() -> None:
    global _ENDPOINT_INSTALLED
    if _ENDPOINT_INSTALLED:
        return
    from distkeras_tpu_torch.telemetry import flightdeck

    flightdeck.add_endpoint("/slo", slo_view)
    _ENDPOINT_INSTALLED = True


# --------------------------------------------------------- default objectives


def default_serving_objectives(ttft_threshold: float = 0.25,
                               latency_threshold: float = 0.5,
                               fast_s: float = 30.0, slow_s: float = 120.0,
                               burn_threshold: float = 2.0,
                               ) -> List[SLOConfig]:
    """The serving tier's shipped objectives — what the probe loop
    evaluates and the future autoscaler verb will act on."""
    return [
        SLOConfig(
            name="serving_ttft_p99", kind="quantile",
            metric="serving_ttft_seconds", quantile=0.99,
            threshold=ttft_threshold, target=0.99,
            fast_window_s=fast_s, slow_window_s=slow_s,
            burn_threshold=burn_threshold,
            description=f"p99 time-to-first-token under "
                        f"{ttft_threshold * 1000:g}ms",
        ),
        SLOConfig(
            name="serving_tier_latency_p99", kind="quantile",
            metric="serving_tier_latency_seconds", quantile=0.99,
            threshold=latency_threshold, target=0.99,
            fast_window_s=fast_s, slow_window_s=slow_s,
            burn_threshold=burn_threshold,
            description=f"p99 end-to-end router latency under "
                        f"{latency_threshold * 1000:g}ms "
                        f"(failovers included)",
        ),
        SLOConfig(
            name="serving_tier_replicas_available", kind="gauge",
            metric="serving_tier_replicas_healthy", threshold=1.0, op="lt",
            target=0.9, fast_window_s=fast_s, slow_window_s=slow_s,
            burn_threshold=burn_threshold,
            description="at least one healthy replica behind the router",
        ),
        SLOConfig(
            name="serving_tier_shed_ratio", kind="ratio",
            bad_metric="serving_tier_sheds_total",
            total_metric=("serving_tier_routed_total",
                          "serving_tier_sheds_total"),
            target=0.99, fast_window_s=fast_s, slow_window_s=slow_s,
            burn_threshold=burn_threshold,
            description="requests shed for saturation under 1% of admitted",
        ),
    ]


def default_online_objectives(window_seconds: float,
                              fast_s: float = 30.0, slow_s: float = 120.0,
                              burn_threshold: float = 2.0,
                              ) -> List[SLOConfig]:
    """The online-learning loop's shipped objective: the retrainer keeps up
    — published-but-untrained windows never age past 2× the window span."""
    return [
        SLOConfig(
            name="online_window_lag", kind="gauge",
            metric="online_window_lag_seconds",
            threshold=2.0 * float(window_seconds), op="gt",
            target=0.9, fast_window_s=fast_s, slow_window_s=slow_s,
            burn_threshold=burn_threshold,
            description=f"oldest untrained window younger than "
                        f"{2.0 * float(window_seconds):g}s (2x window span)",
        ),
    ]
