"""Time-series rollup ring: bounded history for every registered instrument.

The port of :mod:`distkeras_tpu.telemetry.flightdeck.rollup` (host code,
copied).

The metrics registry answers "what is the value *now*"; SLO evaluation and
the autoscaler need "what happened over the last N seconds".  This module
closes that gap with a fixed-interval, fixed-capacity ring of registry
snapshots — each tick stores, per instrument, the counter value, the gauge
value, or the histogram's cumulative bucket counts.  Windowed questions are
then answered by *differencing* two ticks:

* counter rate over a window = (value_now - value_then) / dt;
* histogram quantile over a window = quantile of the bucket-count deltas
  between the window's edges (exact on bucket boundaries — the estimator
  interpolates linearly *within* a bucket only);
* gauge breach fraction = share of ticks in the window above a threshold.

Storing cumulative buckets per tick (rather than pre-computed quantiles) is
what makes fleet merging exact: the daemon merges per-job ticks with the
same carry-forward union used by ``metrics._merge_histograms``, and
quantiles are computed *after* the merge, never averaged across jobs.

Everything is opt-in behind ``DISTKERAS_ROLLUP`` (seconds per tick; unset =
off).  With the flag off no thread starts, no memory is held, and
instrumented code paths are byte-identical — pinned by test.  Tests drive
rings directly with an injectable clock and manual :meth:`RollupRing.tick`.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional

from distkeras_tpu_torch.telemetry import runtime as _runtime

__all__ = [
    "RollupRing",
    "configure",
    "ensure_rollup",
    "interval",
    "merge_series",
    "quantile_from_cumulative",
    "rollup_ring",
    "stop",
    "timeseries_view",
]

DEFAULT_CAPACITY = 512

_UNSET = object()

# _UNSET = not yet resolved from the environment; None = off; float = tick
# interval in seconds once resolved or forced via configure().
_INTERVAL = _UNSET

_RING: Optional["RollupRing"] = None
_THREAD: Optional[threading.Thread] = None
_STOP = threading.Event()
_LOCK = threading.Lock()


def interval() -> Optional[float]:
    """Resolved tick interval in seconds, or ``None`` when rollups are off.
    Cached after the first environment read."""
    global _INTERVAL
    if _INTERVAL is _UNSET:
        raw = os.environ.get("DISTKERAS_ROLLUP", "").strip()
        if raw == "" or raw.lower() in ("off", "false", "no", "0"):
            _INTERVAL = None
        else:
            _INTERVAL = float(raw)
    return _INTERVAL


def configure(seconds=_UNSET) -> None:
    """Force the tick interval (float seconds), turn rollups off
    (``False``), or reset to env-driven (``None``, re-read lazily)."""
    global _INTERVAL
    if seconds is None:
        _INTERVAL = _UNSET
    elif seconds is False:
        _INTERVAL = None
    else:
        _INTERVAL = float(seconds)


class RollupRing:
    """Fixed-capacity ring of per-instrument samples at a fixed cadence.

    One entry per tick: ``(unix, {name: sample})`` where a sample is
    ``{"type": "counter"|"gauge", "value": v}`` or ``{"type": "histogram",
    "sum": s, "count": n, "buckets": {le: cumulative}}`` — the same shapes
    :meth:`Registry.snapshot` emits, so merging reuses the registry's
    histogram algebra.  All mutation is behind one lock; readers copy out.
    """

    def __init__(self, registry=None, interval: float = 10.0,
                 capacity: int = DEFAULT_CAPACITY, clock=time.time):
        if registry is None:
            from distkeras_tpu_torch.telemetry.metrics import metrics as registry
        self.registry = registry
        self.interval = float(interval)
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._buf: List[Optional[tuple]] = [None] * self.capacity
        self._idx = 0

    # ------------------------------------------------------------- recording

    def tick(self, now: Optional[float] = None) -> None:
        """Snapshot the registry into the ring (one entry, oldest evicted)."""
        entry = (self.clock() if now is None else float(now),
                 self.registry.snapshot())
        with self._lock:
            self._buf[self._idx % self.capacity] = entry
            self._idx += 1

    def ingest(self, unix: float, snapshot: dict) -> None:
        """Append an externally produced sample (the daemon's fleet-merged
        ticks land here so ``dkmon watch`` sees one ring, not N)."""
        with self._lock:
            self._buf[self._idx % self.capacity] = (float(unix), snapshot)
            self._idx += 1

    # ------------------------------------------------------------ inspection

    def samples(self, since: Optional[float] = None) -> List[tuple]:
        """``[(unix, snapshot), ...]`` oldest first, optionally bounded."""
        with self._lock:
            if self._idx <= self.capacity:
                raw = self._buf[: self._idx]
            else:
                head = self._idx % self.capacity
                raw = self._buf[head:] + self._buf[:head]
        if since is None:
            return list(raw)
        return [s for s in raw if s[0] >= since]

    def __len__(self) -> int:
        with self._lock:
            return min(self._idx, self.capacity)

    def _window_edges(self, name: str, window_s: float,
                      now: Optional[float] = None):
        """(oldest, newest) samples of ``name`` inside the window, or None.

        ``oldest`` is the last sample at-or-before the window start when one
        exists (so a 60s window spans the full 60s, not just the ticks that
        happen to land inside it)."""
        now = self.clock() if now is None else float(now)
        start = now - float(window_s)
        before, inside = None, []
        for unix, snap in self.samples():
            payload = snap.get(name)
            if payload is None or unix > now:
                continue
            if unix <= start:
                before = (unix, payload)
            else:
                inside.append((unix, payload))
        if not inside:
            return None
        oldest = before if before is not None else inside[0]
        newest = inside[-1]
        if newest[0] <= oldest[0]:
            return None
        return oldest, newest

    def window_rate(self, name: str, window_s: float,
                    now: Optional[float] = None) -> Optional[float]:
        """Counter increase per second over the window (``None`` without at
        least two usable ticks).  Clamped at zero across registry resets."""
        edges = self._window_edges(name, window_s, now)
        if edges is None:
            return None
        (t0, p0), (t1, p1) = edges
        if p0.get("type") != "counter" or p1.get("type") != "counter":
            return None
        return max(0.0, p1["value"] - p0["value"]) / (t1 - t0)

    def window_delta(self, name: str, window_s: float,
                     now: Optional[float] = None) -> Optional[dict]:
        """Histogram activity inside the window: bucket-count deltas between
        the window's edge ticks, as a cumulative snapshot-shaped dict."""
        edges = self._window_edges(name, window_s, now)
        if edges is None:
            return None
        (_, p0), (_, p1) = edges
        if p0.get("type") != "histogram" or p1.get("type") != "histogram":
            return None
        buckets = {}
        for le, n in p1["buckets"].items():
            buckets[le] = max(0, n - p0["buckets"].get(le, 0))
        return {
            "type": "histogram",
            "sum": max(0.0, p1["sum"] - p0["sum"]),
            "count": max(0, p1["count"] - p0["count"]),
            "buckets": buckets,
        }

    def window_quantile(self, name: str, q: float, window_s: float,
                        now: Optional[float] = None) -> Optional[float]:
        """q-quantile of observations that landed inside the window."""
        delta = self.window_delta(name, window_s, now)
        if delta is None or delta["count"] == 0:
            return None
        return quantile_from_cumulative(delta["buckets"], q)

    def window_breach_fraction(self, name: str, threshold: float,
                               window_s: float, now: Optional[float] = None,
                               op: str = "gt") -> Optional[float]:
        """Share of in-window gauge ticks breaching ``threshold`` —
        strictly above for ``op="gt"`` (a lag gauge), strictly below for
        ``op="lt"`` (a healthy-replica count)."""
        if op not in ("gt", "lt"):
            raise ValueError(f"op must be 'gt' or 'lt', got {op!r}")
        now = self.clock() if now is None else float(now)
        start = now - float(window_s)
        seen = bad = 0
        for unix, snap in self.samples(since=start):
            payload = snap.get(name)
            if payload is None or payload.get("type") != "gauge" \
                    or unix > now:
                continue
            seen += 1
            value = payload["value"]
            if (value > threshold) if op == "gt" else (value < threshold):
                bad += 1
        if seen == 0:
            return None
        return bad / seen

    def export(self, since: Optional[float] = None,
               names: Optional[List[str]] = None) -> dict:
        """JSON view for the ``/timeseries`` endpoint and the fleet merge."""
        out = []
        for unix, snap in self.samples(since=since):
            if names:
                snap = {k: v for k, v in snap.items() if k in names}
            out.append({"unix": unix, "metrics": snap})
        return {"interval": self.interval, "capacity": self.capacity,
                "samples": out}


def quantile_from_cumulative(buckets: Dict[str, float], q: float) -> float:
    """q-quantile from cumulative ``{le: count}`` buckets.

    Exact on bucket boundaries: when the target rank lands exactly on a
    bucket's cumulative count, that bucket's upper bound is returned.
    Inside a bucket the estimator interpolates linearly from the previous
    bound (0 for the first finite bucket).  Ranks that land in the +Inf
    overflow clamp to the largest finite bound — bounded ladders cannot
    resolve beyond their top rung, and a finite answer keeps thresholds
    comparable.  Monotone in ``q`` and under carry-forward merges of
    different ladders (both only ever move cumulative counts up)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    from distkeras_tpu_torch.telemetry.metrics import _le_key

    ladder = sorted(((_le_key(le), n) for le, n in buckets.items()))
    total = ladder[-1][1] if ladder else 0
    if total <= 0:
        return 0.0
    rank = q * total
    prev_bound, prev_cum = 0.0, 0
    top_finite = max((b for b, _ in ladder if not math.isinf(b)), default=0.0)
    for bound, cum in ladder:
        if cum > prev_cum and rank <= cum:
            if math.isinf(bound):
                return top_finite
            frac = max(0.0, (rank - prev_cum) / (cum - prev_cum))
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = (0.0 if math.isinf(bound) else bound), cum
    return top_finite


def merge_series(series: List[dict], align_s: float = 1.0) -> dict:
    """Merge per-job ``export()`` payloads into one fleet time-series.

    Ticks from different jobs are binned onto a shared time axis (bins of
    ``align_s``... the rollup interval is the natural choice) and each bin's
    snapshots merge with :func:`metrics.merge_snapshots` — counters sum,
    gauges keep max+mean, histogram buckets union exactly.  Bins where a job
    is silent simply contribute nothing (no interpolation: absence of a tick
    is itself a signal ``dkmon`` surfaces)."""
    from distkeras_tpu_torch.telemetry.metrics import merge_snapshots

    bins: Dict[float, List[dict]] = {}
    interval_out = align_s
    for payload in series:
        interval_out = max(interval_out, float(payload.get("interval") or 0))
        for sample in payload.get("samples", ()):
            key = math.floor(sample["unix"] / align_s) * align_s
            bins.setdefault(key, []).append(sample["metrics"])
    samples = [
        {"unix": key, "metrics": merge_snapshots(snaps)}
        for key, snaps in sorted(bins.items())
    ]
    return {"interval": interval_out, "capacity": len(samples),
            "samples": samples}


# ------------------------------------------------------------ process global


def rollup_ring() -> Optional[RollupRing]:
    """The process-global ring, or ``None`` when rollups are off."""
    return _RING


def ensure_rollup() -> Optional[RollupRing]:
    """Start the rollup thread once (idempotent) and return the ring.

    ``None`` when telemetry or ``DISTKERAS_ROLLUP`` is off — entry points
    call this unconditionally, like :func:`server.ensure_server`.
    """
    if not _runtime.enabled():
        return None
    dt = interval()
    if dt is None:
        return None
    global _RING, _THREAD
    with _LOCK:
        if _RING is None:
            _RING = RollupRing(interval=dt)
            _STOP.clear()
            _THREAD = threading.Thread(
                target=_run, args=(_RING,), name="flightdeck-rollup",
                daemon=True,
            )
            _THREAD.start()
    return _RING


def _run(ring: RollupRing) -> None:
    while not _STOP.wait(ring.interval):
        try:
            ring.tick()
        except Exception:  # noqa: BLE001 — a rollup must never kill training
            pass


def stop() -> None:
    """Stop the rollup thread and drop the ring (tests, daemon teardown)."""
    global _RING, _THREAD
    with _LOCK:
        ring, _RING = _RING, None
        thread, _THREAD = _THREAD, None
        _STOP.set()
    if thread is not None:
        thread.join(timeout=5)


def timeseries_view(request: Optional[dict] = None):
    """``/timeseries`` endpoint body: the live ring (404-shaped JSON when
    rollups are off so scrapers can tell "off" from "empty")."""
    import json
    from urllib.parse import parse_qs

    ring = _RING
    if ring is None:
        return ("application/json",
                json.dumps({"enabled": False, "samples": []}), 200)
    query = parse_qs((request or {}).get("query") or "")
    since = query.get("since")
    names = query.get("name")
    payload = ring.export(
        since=float(since[-1]) if since else None,
        names=names or None,
    )
    payload["enabled"] = True
    return ("application/json", json.dumps(payload), 200)
