"""dkcost — per-tenant resource accounting and fair-share attribution: the
port of :mod:`distkeras_tpu.telemetry.accounting` (host code, copied).

The serving stack mints trace ids and evaluates SLO burn rates, but until
this module nothing attributed *resources* to the clients consuming them:
``GenerateRequest.tenant`` is the accounting key, and this is the ledger it
keys.  Every request is metered from already-host-visible bookkeeping (zero
new device syncs) and rolled up per tenant:

* **prefill tokens** — prompt tokens consumed at admission;
* **decode tokens** — generated tokens (first sampled token included), so
  the tenant-summed count equals ``serving_tokens_total`` *exactly* — the
  conservation invariant tests pin;
* **speculative accept/reject tokens** — the draft-token split, conserving
  against ``serving_spec_{proposed,accepted}_total``;
* **queue-wait seconds** — enqueue to prefill dispatch, on a fixed bucket
  ladder per tenant so fleet merges and p99s are exact;
* **KV page-seconds** — pages held × wall seconds, sampled at slot free;
* **estimated device-seconds** split by phase — prefill wall time, plus an
  even share of each decode step's wall time across the active slots.

Cardinality is **bounded by construction** (DK117-safe): the ledger tracks
the top-K tenants by rolling usage (exponentially-decayed token mass) plus
one ``__other__`` overflow bucket; admitting tenant K+1 folds the
smallest-usage entry into ``__other__`` — totals conserve across eviction,
and the series count never exceeds K+1.  Per-tenant breakdowns are served
as JSON (the flightdeck ``/ledger`` endpoint and the Punchcard daemon's
``ledger_status`` verb, which merges its live jobs' tables with its own;
``dkmon top`` is the JAX package's ``tools/``); only *aggregate* ``accounting_*``
instruments enter the metrics registry, so rollups, SLOs, and the fleet
merge see fixed names.

Flag discipline matches telemetry/rollup: ``DISTKERAS_ACCOUNTING=0``
disables the ledger entirely — :func:`maybe_ledger` returns ``None``, the
serving hot paths keep a single ``is None`` check, and the ledger never
touches a tensor: it reads host-visible values only, adds no device sync,
and the device work is the same bit for bit.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref
from typing import Dict, List, Optional

from distkeras_tpu_torch.telemetry import runtime as _truntime

__all__ = [
    "DEFAULT_CAPACITY",
    "OTHER_TENANT",
    "QUEUE_WAIT_BUCKETS",
    "TenantLedger",
    "UNTAGGED_TENANT",
    "accounting_metrics",
    "configure",
    "enabled",
    "ledger_for",
    "ledger_payload",
    "ledger_view",
    "maybe_ledger",
    "merge_ledgers",
    "reset",
]

#: overflow bucket evicted tenants fold into — the "+1" of top-K+1
OTHER_TENANT = "__other__"

#: requests that arrive without a tenant key
UNTAGGED_TENANT = "__untagged__"

#: tracked tenants before eviction into ``__other__`` begins
DEFAULT_CAPACITY = 8

#: rolling-usage decay constant (seconds) — the window "tokens/sec" means
DEFAULT_TAU_S = 30.0

#: fixed per-tenant queue-wait ladder (coarse subset of the registry's
#: DEFAULT_BUCKETS).  Shared by every ledger so cross-process merges sum
#: bucket-exact and the merged p99 stays honest.
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.5, 2.5, 10.0)

_FALSEY = ("", "0", "false", "no")

# None = not yet resolved from the environment; True/False once resolved
# or forced via configure().  Accounting defaults ON when telemetry is on.
_ENABLED = None


def _flag() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get(
            "DISTKERAS_ACCOUNTING", "1").lower() not in _FALSEY
    return _ENABLED


def enabled() -> bool:
    """True when per-tenant accounting is on: telemetry enabled AND
    ``DISTKERAS_ACCOUNTING`` not falsey (unset counts as on)."""
    return _truntime.enabled() and _flag()


def configure(on=None) -> None:
    """Force accounting on/off (``True``/``False``) or reset to env-driven
    (``None``) — same contract as :func:`telemetry.runtime.configure`.
    Telemetry itself must still be enabled for :func:`enabled` to be true."""
    global _ENABLED
    _ENABLED = on


def accounting_metrics(registry=None) -> dict:
    """Get-or-create the *aggregate* accounting instruments (default: the
    process-global registry).  One canonical home for names/help so the
    ledger, the golden test, and the CI smoke assert the same schema.
    Per-tenant breakdowns deliberately never enter the registry — they live
    in the ledger's bounded table, served as JSON (DK117)."""
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
    return {
        "requests": registry.counter(
            "accounting_requests_total",
            help="requests billed to a tenant at the router (one per "
                 "request; failed failover attempts fold into the same "
                 "request, never billed twice)",
        ),
        "failover_attempts": registry.counter(
            "accounting_failover_attempts_total",
            help="extra dispatch attempts beyond the first, billed once "
                 "to the owning request at completion",
        ),
        "prefill_tokens": registry.counter(
            "accounting_prefill_tokens_total",
            help="prompt tokens prefilled, summed over tenants",
        ),
        "decode_tokens": registry.counter(
            "accounting_decode_tokens_total",
            help="generated tokens billed to tenants (tenant-summed this "
                 "equals serving_tokens_total exactly — conservation)",
        ),
        "spec_accepted": registry.counter(
            "accounting_spec_accepted_tokens_total",
            help="speculative draft tokens accepted, billed per tenant",
        ),
        "spec_rejected": registry.counter(
            "accounting_spec_rejected_tokens_total",
            help="speculative draft tokens rejected, billed per tenant",
        ),
        "queue_wait": registry.histogram(
            "accounting_queue_wait_seconds",
            help="per-request admission-queue wait billed to tenants",
        ),
        "page_seconds": registry.counter(
            "accounting_kv_page_seconds_total",
            help="KV page-seconds (pages held x wall seconds, sampled at "
                 "slot free)",
        ),
        "prefill_device_seconds": registry.counter(
            "accounting_prefill_device_seconds_total",
            help="estimated device-seconds spent in prefill, billed to "
                 "the admitted tenant",
        ),
        "decode_device_seconds": registry.counter(
            "accounting_decode_device_seconds_total",
            help="estimated device-seconds spent in decode (each step's "
                 "wall time split evenly across its active slots)",
        ),
        "tenants_tracked": registry.gauge(
            "accounting_tenants_tracked",
            help="tenants currently holding a ledger row (bounded top-K; "
                 "__other__ excluded)",
        ),
        "evictions": registry.counter(
            "accounting_tenant_evictions_total",
            help="ledger rows folded into __other__ to keep cardinality "
                 "fixed",
        ),
    }


class _TenantEntry:
    """One tenant's cumulative usage plus its decayed rolling-rate state."""

    __slots__ = (
        "tenant", "requests", "failover_attempts", "prefill_tokens",
        "decode_tokens", "spec_accepted", "spec_rejected", "queue_wait_s",
        "queue_counts", "page_seconds", "prefill_device_s",
        "decode_device_s", "rate_tokens", "rate_requests", "rate_t",
    )

    def __init__(self, tenant: str, now: float):
        self.tenant = tenant
        self.requests = 0
        self.failover_attempts = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.spec_accepted = 0
        self.spec_rejected = 0
        self.queue_wait_s = 0.0
        self.queue_counts = [0] * (len(QUEUE_WAIT_BUCKETS) + 1)
        self.page_seconds = 0.0
        self.prefill_device_s = 0.0
        self.decode_device_s = 0.0
        # exponentially-decayed mass: rate = mass / tau
        self.rate_tokens = 0.0
        self.rate_requests = 0.0
        self.rate_t = now

    def decay(self, now: float, tau: float) -> None:
        dt = now - self.rate_t
        if dt > 0.0:
            f = math.exp(-dt / tau)
            self.rate_tokens *= f
            self.rate_requests *= f
            self.rate_t = now


class TenantLedger:
    """Bounded per-tenant usage table: top-``capacity`` tenants by rolling
    usage plus the ``__other__`` overflow bucket.  Thread-safe — the
    engine's loop thread, the router's dispatch threads, and HTTP scrapes
    all meter/read concurrently.  Every billing call also feeds the aggregate
    ``accounting_*`` instruments on ``registry``, so the fleet-mergeable
    totals and the per-tenant table can never drift apart."""

    def __init__(self, registry=None, *, capacity: int = DEFAULT_CAPACITY,
                 tau_s: float = DEFAULT_TAU_S, clock=time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.tau_s = float(tau_s)
        self._clock = clock
        self._metrics = accounting_metrics(registry)
        # re-entrant: billing sites hold it across _entry/_fold_into_other,
        # which also lock themselves — every write provably guarded (DK105)
        self._lock = threading.RLock()
        self._tenants: Dict[str, _TenantEntry] = {}
        self._evictions = 0

    # ------------------------------------------------------------ internals

    def _entry(self, tenant: str, now: float) -> _TenantEntry:
        name = str(tenant or "") or UNTAGGED_TENANT
        with self._lock:
            entry = self._tenants.get(name)
            if entry is not None:
                return entry
            if name != OTHER_TENANT:
                live = [e for n, e in self._tenants.items()
                        if n != OTHER_TENANT]
                if len(live) >= self.capacity:
                    # fold the coldest row into __other__: the newcomer gets
                    # a row (a late-arriving hot tenant must become visible),
                    # the evicted tail keeps its totals — conservation holds
                    for e in live:
                        e.decay(now, self.tau_s)
                    victim = min(live,
                                 key=lambda e: (e.rate_tokens, e.tenant))
                    self._fold_into_other(victim, now)
            entry = _TenantEntry(name, now)
            self._tenants[name] = entry
            tracked = sum(1 for n in self._tenants if n != OTHER_TENANT)
        self._metrics["tenants_tracked"].set(tracked)
        return entry

    def _fold_into_other(self, victim: _TenantEntry, now: float) -> None:
        with self._lock:
            other = self._tenants.get(OTHER_TENANT)
            if other is None:
                other = _TenantEntry(OTHER_TENANT, now)
                self._tenants[OTHER_TENANT] = other
            other.decay(now, self.tau_s)
            victim.decay(now, self.tau_s)
            other.requests += victim.requests
            other.failover_attempts += victim.failover_attempts
            other.prefill_tokens += victim.prefill_tokens
            other.decode_tokens += victim.decode_tokens
            other.spec_accepted += victim.spec_accepted
            other.spec_rejected += victim.spec_rejected
            other.queue_wait_s += victim.queue_wait_s
            for i, n in enumerate(victim.queue_counts):
                other.queue_counts[i] += n
            other.page_seconds += victim.page_seconds
            other.prefill_device_s += victim.prefill_device_s
            other.decode_device_s += victim.decode_device_s
            other.rate_tokens += victim.rate_tokens
            other.rate_requests += victim.rate_requests
            del self._tenants[victim.tenant]
            self._evictions += 1
        self._metrics["evictions"].inc()

    def _observe_queue(self, entry: _TenantEntry, seconds: float) -> None:
        entry.queue_wait_s += seconds
        for i, bound in enumerate(QUEUE_WAIT_BUCKETS):
            if seconds <= bound:
                entry.queue_counts[i] += 1
                return
        entry.queue_counts[-1] += 1

    # -------------------------------------------------------- billing sites

    def admit(self, tenant: str, *, prompt_tokens: int, queue_wait_s: float,
              device_s: float, generated: int = 1) -> None:
        """Bill one admission (the engine's prefill site): prompt tokens,
        queue wait, prefill device-seconds, and the first sampled token."""
        now = self._clock()
        with self._lock:
            entry = self._entry(tenant, now)
            entry.decay(now, self.tau_s)
            entry.prefill_tokens += int(prompt_tokens)
            entry.decode_tokens += int(generated)
            self._observe_queue(entry, float(queue_wait_s))
            entry.prefill_device_s += float(device_s)
            entry.rate_tokens += float(prompt_tokens + generated)
        self._metrics["prefill_tokens"].inc(int(prompt_tokens))
        if generated:
            self._metrics["decode_tokens"].inc(int(generated))
        self._metrics["queue_wait"].observe(float(queue_wait_s))
        self._metrics["prefill_device_seconds"].inc(float(device_s))

    def decode(self, tenant: str, *, tokens: int, device_s: float) -> None:
        """Bill one slot's share of a decode step: emitted tokens plus an
        even split of the step's wall time."""
        now = self._clock()
        with self._lock:
            entry = self._entry(tenant, now)
            entry.decay(now, self.tau_s)
            entry.decode_tokens += int(tokens)
            entry.decode_device_s += float(device_s)
            entry.rate_tokens += float(tokens)
        if tokens:
            self._metrics["decode_tokens"].inc(int(tokens))
        self._metrics["decode_device_seconds"].inc(float(device_s))

    def speculative(self, tenant: str, *, accepted: int,
                    rejected: int) -> None:
        """Bill one slot's speculative verify verdict."""
        now = self._clock()
        with self._lock:
            entry = self._entry(tenant, now)
            entry.spec_accepted += int(accepted)
            entry.spec_rejected += int(rejected)
        self._metrics["spec_accepted"].inc(int(accepted))
        self._metrics["spec_rejected"].inc(int(rejected))

    def release(self, tenant: str, *, pages: int, held_s: float) -> None:
        """Sample page-seconds at slot free: pages held × wall seconds."""
        page_s = float(pages) * max(0.0, float(held_s))
        now = self._clock()
        with self._lock:
            entry = self._entry(tenant, now)
            entry.page_seconds += page_s
        self._metrics["page_seconds"].inc(page_s)

    def request(self, tenant: str, *, attempts: int = 1,
                latency_s: float = 0.0) -> None:
        """Router-level attribution, called exactly once per completed
        request: failed failover attempts bill here as ``attempts - 1``,
        never per attempt."""
        del latency_s  # router latency already has a registry histogram
        extra = max(0, int(attempts) - 1)
        now = self._clock()
        with self._lock:
            entry = self._entry(tenant, now)
            entry.decay(now, self.tau_s)
            entry.requests += 1
            entry.failover_attempts += extra
            entry.rate_requests += 1.0
        self._metrics["requests"].inc()
        if extra:
            self._metrics["failover_attempts"].inc(extra)

    # ------------------------------------------------------------ inspection

    def rolling_rate(self, tenant: str, unit: str = "tokens") -> float:
        """The tenant's decayed usage rate in ``unit``/sec (``"tokens"`` or
        ``"requests"``); 0.0 for an unknown tenant.  This is the signal the
        online capture's ``SamplingPolicy`` rate (ROADMAP Queue A item 18)
        policy keys off, and the ranking evictions use."""
        if unit not in ("tokens", "requests"):
            raise ValueError(f"unit must be 'tokens' or 'requests', got {unit!r}")
        name = str(tenant or "") or UNTAGGED_TENANT
        now = self._clock()
        with self._lock:
            entry = self._tenants.get(name)
            if entry is None:
                return 0.0
            entry.decay(now, self.tau_s)
            mass = (entry.rate_tokens if unit == "tokens"
                    else entry.rate_requests)
        return mass / self.tau_s

    def snapshot(self) -> dict:
        """JSON-safe per-tenant table (the ``/ledger`` endpoint body and
        ``dkmon top``'s input), sorted by total tokens descending.  Bucket
        counts ride along so :func:`merge_ledgers` merges exactly."""
        now = self._clock()
        with self._lock:
            rows = []
            for entry in self._tenants.values():
                entry.decay(now, self.tau_s)
                rows.append({
                    "tenant": entry.tenant,
                    "requests": entry.requests,
                    "failover_attempts": entry.failover_attempts,
                    "prefill_tokens": entry.prefill_tokens,
                    "decode_tokens": entry.decode_tokens,
                    "spec_accepted": entry.spec_accepted,
                    "spec_rejected": entry.spec_rejected,
                    "queue_wait_s": entry.queue_wait_s,
                    "queue_buckets": _cumulative_buckets(entry.queue_counts),
                    "page_seconds": entry.page_seconds,
                    "device_seconds": {
                        "prefill": entry.prefill_device_s,
                        "decode": entry.decode_device_s,
                    },
                    "tokens_per_s": entry.rate_tokens / self.tau_s,
                    "requests_per_s": entry.rate_requests / self.tau_s,
                })
            evictions = self._evictions
        return _finish_payload(rows, evictions, capacity=self.capacity)


def _cumulative_buckets(counts: List[int]) -> Dict[str, int]:
    out, cum = {}, 0
    for bound, n in zip(QUEUE_WAIT_BUCKETS, counts):
        cum += n
        out[repr(float(bound))] = cum
    out["+Inf"] = cum + counts[-1]
    return out


def _finish_payload(rows: List[dict], evictions: int,
                    capacity: Optional[int] = None) -> dict:
    """Sort rows, stamp share-of-fleet and queue p99, and total up."""
    from distkeras_tpu_torch.telemetry.flightdeck.rollup import (
        quantile_from_cumulative,
    )

    total_tokens = sum(r["prefill_tokens"] + r["decode_tokens"] for r in rows)
    for row in rows:
        mine = row["prefill_tokens"] + row["decode_tokens"]
        row["share"] = (mine / total_tokens) if total_tokens else 0.0
        row["queue_p99_s"] = quantile_from_cumulative(
            row["queue_buckets"], 0.99)
    rows.sort(key=lambda r: (-(r["prefill_tokens"] + r["decode_tokens"]),
                             r["tenant"]))
    payload = {
        "enabled": True,
        "tenants": rows,
        "evictions": int(evictions),
        "totals": {
            "tokens": total_tokens,
            "requests": sum(r["requests"] for r in rows),
            "page_seconds": sum(r["page_seconds"] for r in rows),
        },
    }
    if capacity is not None:
        payload["capacity"] = int(capacity)
    return payload


def merge_ledgers(payloads: List[dict]) -> dict:
    """Fleet-merge ledger snapshots tenant-wise by name: counters and
    page/device/queue sums add, rolling rates add (fleet tokens/sec is
    additive), bucket counts add per bound so the merged p99 is as exact
    as any single ladder.  Share is recomputed over the merged totals."""
    merged: Dict[str, dict] = {}
    evictions = 0
    for payload in payloads:
        if not payload:
            continue
        evictions += int(payload.get("evictions") or 0)
        for row in payload.get("tenants") or ():
            name = row["tenant"]
            into = merged.get(name)
            if into is None:
                into = {
                    "tenant": name, "requests": 0, "failover_attempts": 0,
                    "prefill_tokens": 0, "decode_tokens": 0,
                    "spec_accepted": 0, "spec_rejected": 0,
                    "queue_wait_s": 0.0, "queue_buckets": {},
                    "page_seconds": 0.0,
                    "device_seconds": {"prefill": 0.0, "decode": 0.0},
                    "tokens_per_s": 0.0, "requests_per_s": 0.0,
                }
                merged[name] = into
            for key in ("requests", "failover_attempts", "prefill_tokens",
                        "decode_tokens", "spec_accepted", "spec_rejected"):
                into[key] += int(row.get(key) or 0)
            for key in ("queue_wait_s", "page_seconds", "tokens_per_s",
                        "requests_per_s"):
                into[key] += float(row.get(key) or 0.0)
            for phase in ("prefill", "decode"):
                into["device_seconds"][phase] += float(
                    (row.get("device_seconds") or {}).get(phase) or 0.0)
            for le, cum in (row.get("queue_buckets") or {}).items():
                into["queue_buckets"][le] = (
                    into["queue_buckets"].get(le, 0) + int(cum))
    return _finish_payload(list(merged.values()), evictions)


# ------------------------------------------------------- per-registry wiring

_LEDGERS = weakref.WeakKeyDictionary()
_LEDGER_LOCK = threading.Lock()
_GLOBAL_KEY = None


def ledger_for(registry=None) -> TenantLedger:
    """Get-or-create the ledger bound to ``registry`` (default: the
    process-global one) — same get-or-create discipline as the metric
    helpers, so an engine and its router share one table per registry."""
    global _GLOBAL_KEY
    if registry is None:
        from distkeras_tpu_torch.telemetry.metrics import metrics as registry
        _GLOBAL_KEY = registry
    with _LEDGER_LOCK:
        ledger = _LEDGERS.get(registry)
        if ledger is None:
            ledger = TenantLedger(registry)
            _LEDGERS[registry] = ledger
        return ledger


def maybe_ledger(registry=None) -> Optional[TenantLedger]:
    """The serving hot-path hook: the registry's ledger when accounting is
    enabled, else ``None`` (callers keep a single ``is None`` check)."""
    if not enabled():
        return None
    return ledger_for(registry)


def reset() -> None:
    """Drop every cached ledger (tests; pairs with ``metrics.reset()``)."""
    with _LEDGER_LOCK:
        _LEDGERS.clear()


def ledger_payload() -> dict:
    """The process-global ledger's snapshot, or the disabled shape — what
    the daemon's ``ledger_status`` verb reports for its own process."""
    if not enabled():
        return {"enabled": False, "tenants": []}
    return ledger_for().snapshot()


def ledger_view(request: Optional[dict] = None):
    """``/ledger`` flightdeck endpoint body: the process-global ledger as
    JSON (disabled-shaped when accounting is off, so scrapers can tell
    "off" from "idle")."""
    del request
    return ("application/json", json.dumps(ledger_payload()), 200)
