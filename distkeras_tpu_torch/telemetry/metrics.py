"""Metrics registry: counters, gauges, bounded-bucket histograms.

The port of :mod:`distkeras_tpu.telemetry.metrics`' registry core, copied:
it is framework-neutral host code.  Instruments are get-or-create through a
process-global :data:`metrics` registry, so call sites never need to
coordinate construction:

    telemetry.metrics.counter("checkpoints_saved_total").inc()
    telemetry.metrics.histogram("phase_step_seconds").observe(dt)

Exporters: Prometheus text exposition, JSONL snapshots, and a bridge into
``utils.tb.ScalarLogger``; :func:`merge_snapshots` and
:func:`prometheus_from_snapshot` aggregate per-job snapshots.  The flight
recorder's metric feed and the compile-count hooks come with the telemetry
slice (ROADMAP Queue A item 19).

Histograms are bounded by construction: a fixed bucket ladder plus one
overflow slot, so a runaway workload can never grow memory.  All mutation is
behind a per-instrument lock; reads of a single float/int are atomic in
CPython and done off-lock.
"""

from __future__ import annotations

import bisect
import json
import math
import threading


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "Gauge",
    "Histogram",
    "PHASES",
    "Registry",
    "merge_snapshots",
    "metrics",
    "prometheus_from_snapshot",
]

# Exponential seconds ladder: 100µs .. 60s covers everything from a single
# h2d transfer to a full-epoch dispatch; beyond that lands in +Inf.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# Canonical phase names for the bench breakdown ("where did the step time
# go?").  Spans opened with phase=<name> feed phase_<name>_seconds.
PHASES = ("data", "h2d", "step", "commit")


class Counter:
    """Monotonically increasing float counter."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self):
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value):
        with self._lock:
            self._value = float(value)

    @property
    def value(self):
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` semantics on export)."""

    __slots__ = ("name", "help", "buckets", "_lock", "_counts", "_sum", "_count")

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one finite bucket")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value):
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self):
        with self._lock:
            return self._sum

    @property
    def count(self):
        with self._lock:
            return self._count

    def cumulative(self):
        """[(upper_bound_label, cumulative_count), ...] ending with +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, running = [], 0
        for bound, n in zip(self.buckets, counts):
            running += n
            out.append((_fmt_float(bound), running))
        out.append(("+Inf", running + counts[-1]))
        return out


def _fmt_float(v):
    """Prometheus-friendly number rendering: 0.005, 1, 10 — no 1e-05."""
    s = f"{v:.10f}".rstrip("0").rstrip(".")
    return s if s else "0"


def _label_suffix(labels, first=None):
    """``{le="0.5",run_id="abc"}`` — ``first`` (a ``(k, v)`` pair) leads so
    histogram ``le`` keeps its customary position; the rest sort by key.
    Empty string when there is nothing to render (keeps unlabelled output —
    and its goldens — byte-identical)."""
    pairs = []
    if first is not None:
        pairs.append(first)
    if labels:
        pairs.extend(sorted(labels.items()))
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


class Registry:
    """Get-or-create home for named instruments."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help=help, **kwargs)
                self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}"
            )
        return inst

    def counter(self, name, help="") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def reset(self):
        with self._lock:
            self._instruments.clear()

    # ------------------------------------------------------------ exporters

    def snapshot(self) -> dict:
        """JSON-safe dict of every instrument's current state."""
        with self._lock:
            items = list(self._instruments.items())
        out = {}
        for name, inst in sorted(items):
            if isinstance(inst, Counter):
                out[name] = {"type": "counter", "value": inst.value}
            elif isinstance(inst, Gauge):
                out[name] = {"type": "gauge", "value": inst.value}
            else:
                out[name] = {
                    "type": "histogram",
                    "sum": inst.sum,
                    "count": inst.count,
                    "buckets": {le: n for le, n in inst.cumulative()},
                }
        return out

    def to_prometheus(self, labels=None) -> str:
        """Prometheus text exposition format (v0.0.4).

        ``labels`` (a flat dict) is stamped onto every sample — the live
        scrape passes ``{"run_id": ...}`` so fleet dashboards can join
        processes; ``None`` keeps the output byte-identical to before.
        """
        with self._lock:
            items = list(self._instruments.items())
        sfx = _label_suffix(labels)
        lines = []
        for name, inst in sorted(items):
            kind = ("counter" if isinstance(inst, Counter)
                    else "gauge" if isinstance(inst, Gauge)
                    else "histogram")
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {kind}")
            if kind == "histogram":
                for le, n in inst.cumulative():
                    lines.append(
                        f"{name}_bucket{_label_suffix(labels, ('le', le))} {n}"
                    )
                lines.append(f"{name}_sum{sfx} {_fmt_float(inst.sum)}")
                lines.append(f"{name}_count{sfx} {inst.count}")
            else:
                lines.append(f"{name}{sfx} {_fmt_float(inst.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path, extra=None) -> str:
        """Append one snapshot line to ``path``; returns the path."""
        record = dict(extra or {})
        record["metrics"] = self.snapshot()
        with open(path, "a") as fh:
            fh.write(json.dumps(record) + "\n")
        return path

    def to_scalar_logger(self, logger, step) -> None:
        """Bridge into ``utils.tb.ScalarLogger``: counters/gauges as-is,
        histograms as ``<name>_sum``/``<name>_count``."""
        scalars = {}
        for name, payload in self.snapshot().items():
            if payload["type"] == "histogram":
                scalars[f"{name}_sum"] = payload["sum"]
                scalars[f"{name}_count"] = payload["count"]
            else:
                scalars[name] = payload["value"]
        if scalars:
            logger.log(step, **scalars)

    def phase_breakdown(self) -> dict:
        """Seconds spent per phase, from the ``phase_*_seconds`` histograms
        that span exits feed.  Always contains the canonical four keys."""
        with self._lock:
            items = list(self._instruments.items())
        out = {p: 0.0 for p in PHASES}
        for name, inst in items:
            if (isinstance(inst, Histogram) and name.startswith("phase_")
                    and name.endswith("_seconds")):
                out[name[len("phase_"):-len("_seconds")]] = inst.sum
        return out


# -------------------------------------------------- fleet-level aggregation


def _le_key(le):
    return math.inf if le == "+Inf" else float(le)


def _le_label(le):
    return "+Inf" if _le_key(le) == math.inf else _fmt_float(float(le))


def _merge_histograms(payloads) -> dict:
    """Merge histogram snapshots on their cumulative bounded-bucket form.

    The merged ladder is the union of the inputs' ``le`` labels.  A snapshot
    missing a label contributes its cumulative count at its largest bound
    <= that label (carry-forward) — exact for cumulative distributions, so
    merging loses nothing as long as jobs share a ladder, and degrades
    conservatively (counts attributed to the next coarser bound) when they
    don't.  Sums and counts add."""
    per_snap = []
    labels = set()
    for p in payloads:
        bounds = sorted(((_le_key(le), n) for le, n in p["buckets"].items()))
        per_snap.append(bounds)
        labels.update(_le_key(le) for le in p["buckets"])
    merged = {}
    for le_val in sorted(labels):
        total = 0
        for bounds in per_snap:
            idx = bisect.bisect_right([b for b, _ in bounds], le_val) - 1
            total += bounds[idx][1] if idx >= 0 else 0
        merged[_le_label(le_val)] = total
    return {
        "type": "histogram",
        "sum": sum(p["sum"] for p in payloads),
        "count": sum(p["count"] for p in payloads),
        "buckets": merged,
    }


def merge_snapshots(snapshots) -> dict:
    """Merge per-job :meth:`Registry.snapshot` dicts into one fleet view.

    Counters sum (fleet totals); gauges keep the **max** as their value —
    for health stats the worst worker is the signal — and carry the fleet
    ``mean`` alongside; histograms merge exactly via
    :func:`_merge_histograms`.  Raises on a name registered with different
    types across jobs."""
    merged: dict = {}
    grouped: dict = {}
    for snap in snapshots:
        for name, payload in snap.items():
            grouped.setdefault(name, []).append(payload)
    for name, payloads in sorted(grouped.items()):
        kinds = {p["type"] for p in payloads}
        if len(kinds) > 1:
            raise ValueError(
                f"metric {name!r} has conflicting types across jobs: "
                f"{sorted(kinds)}"
            )
        kind = kinds.pop()
        if kind == "counter":
            merged[name] = {
                "type": "counter",
                "value": sum(p["value"] for p in payloads),
            }
        elif kind == "gauge":
            values = [p["value"] for p in payloads]
            merged[name] = {
                "type": "gauge",
                "value": max(values),
                "mean": sum(values) / len(values),
            }
        else:
            merged[name] = _merge_histograms(payloads)
    return merged


def prometheus_from_snapshot(snapshot, help_map=None, labels=None) -> str:
    """Prometheus text exposition for a snapshot dict (per-job or merged).

    Merged gauges (carrying a ``mean``) export two labelled samples,
    ``{agg="max"}`` and ``{agg="mean"}``; everything else renders exactly
    like :meth:`Registry.to_prometheus`.  ``labels`` stamps every sample
    (the fleet scrape passes the run_id) and composes with ``le``/``agg``."""
    sfx = _label_suffix(labels)
    lines = []
    for name, payload in sorted(snapshot.items()):
        kind = payload["type"]
        help_text = (help_map or {}).get(name)
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == "histogram":
            for le, n in payload["buckets"].items():
                lines.append(
                    f"{name}_bucket{_label_suffix(labels, ('le', le))} {n}"
                )
            lines.append(f"{name}_sum{sfx} {_fmt_float(payload['sum'])}")
            lines.append(f"{name}_count{sfx} {payload['count']}")
        elif kind == "gauge" and "mean" in payload:
            max_sfx = _label_suffix(labels, ("agg", "max"))
            mean_sfx = _label_suffix(labels, ("agg", "mean"))
            lines.append(f"{name}{max_sfx} {_fmt_float(payload['value'])}")
            lines.append(f"{name}{mean_sfx} {_fmt_float(payload['mean'])}")
        else:
            lines.append(f"{name}{sfx} {_fmt_float(payload['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


# Process-global registry: one scrape surface per process, like the tracer.
metrics = Registry()
