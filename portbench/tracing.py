"""The device trace of a ``--trace 1`` run, and the benchmark's own spans.

A :class:`Stretch` runs ``torch.profiler`` (CPU and CUDA activities) over a
short stretch of the window, marked by a ``portbench.stretch`` annotation
between two synchronisations, and writes the Chrome trace under
``$TMPDIR``.  :func:`summarize` reads it back into a
:class:`TraceSummary`: the device operations inside the stretch (kernels,
copies, sets), their union (the busy seconds), and the idle gaps between
them, each named by what the host was doing at its middle.  The
benchmark's spans (:func:`span`) are ``record_function`` annotations around
its calls into each layer of the program, so that a gap can be named by the
layer the host was in.  Kernel times are read from the trace's ``"cat":
"kernel"`` events, as the port's ``telemetry.profiler.kernel_times`` reads
them, in code of the benchmark's own, so that the yardstick stays outside
the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Tuple

#: the annotation that marks a traced stretch
STRETCH = "portbench.stretch"
#: Chrome-trace categories of work that runs on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: host-side categories a gap can be named by, innermost first in each
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
#: idle gaps shorter than this (microseconds) are counted together, unnamed
SHORT_GAP_US = 20.0
#: at most this many entries in each list of the breakdown
BREAKDOWN_ROWS = 10


@contextlib.contextmanager
def span(name: str):
    """A benchmark span around a call into the program: a
    ``record_function`` annotation, which only a running profiler records
    (outside one it costs a function call)."""
    import torch

    with torch.autograd.profiler.record_function(name):
        yield


class Stretch:
    """``torch.profiler`` over a stretch of the window: :meth:`start` and
    :meth:`stop` each synchronise the card, and everything between is
    inside the ``portbench.stretch`` annotation."""

    def __init__(self):
        self._prof = None
        self._mark = None
        self.path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._mark = torch.autograd.profiler.record_function(STRETCH)
        self._mark.__enter__()

    def stop(self) -> str:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(path)
        self._prof = self._mark = None
        self.path = path
        return path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def short_name(name: str) -> str:
    """A kernel's or op's name without its return type, argument list and
    the commonest namespaces, at most 120 characters."""
    name = name.removeprefix("void ")
    for ns in ("(anonymous namespace)::", "at::native::", "at::", "c10::", "std::"):
        name = name.replace(ns, "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:120]


@dataclasses.dataclass
class TraceSummary:
    """What a stretch's trace says.  Times in seconds; ``ops`` are the
    device operations inside the stretch as ``(name, start_s, dur_s)``,
    starts from the stretch's start."""

    window_s: float
    busy_s: float
    ops: List[Tuple[str, float, float]]
    gaps: List[Tuple[str, float]]

    def device_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [d for name, _, d in self.ops if rx.search(name)]
        return sum(hits), len(hits)

    def breakdown(self) -> dict:
        """The device operations that took most time and the host
        activities behind the longest idle time, at most
        :data:`BREAKDOWN_ROWS` each, as the result line carries them."""
        by_op: Dict[str, float] = {}
        for name, _, d in self.ops:
            key = short_name(name)
            by_op[key] = by_op.get(key, 0.0) + d
        by_gap: Dict[str, float] = {}
        for name, d in self.gaps:
            by_gap[name] = by_gap.get(name, 0.0) + d
        top = lambda m: [[k, v] for k, v in sorted(m.items(), key=lambda kv: -kv[1])][:BREAKDOWN_ROWS]
        return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def summarize(path: str) -> TraceSummary:
    """Read the Chrome trace a :class:`Stretch` wrote, and delete it."""
    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    os.remove(path)
    return summarize_events(events)


def summarize_events(events) -> TraceSummary:
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in complete if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError(f"the trace holds no {STRETCH!r} annotation")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    ops = []
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ops.append((e["name"], a, b))
    busy = _union([(a, b) for _, a, b in ops])
    busy_us = sum(b - a for a, b in busy)
    hosts = _HostCalls([e for e in complete
                        if e.get("cat") in HOST_CATS and e.get("name") != STRETCH])
    gaps = []
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a >= SHORT_GAP_US:
            gaps.append((hosts.at((a + b) / 2), (b - a) * 1e-6))
        elif b > a:
            gaps.append((f"gaps under {SHORT_GAP_US:g} us between device operations",
                         (b - a) * 1e-6))
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
        ops=[(name, (a - lo) * 1e-6, (b - a) * 1e-6) for name, a, b in ops], gaps=gaps)


class _HostCalls:
    """The host's spans and calls of a trace, for naming idle gaps."""

    def __init__(self, events):
        import numpy as np

        self.names = [e["name"] for e in events]
        self.start = np.array([float(e["ts"]) for e in events])
        self.dur = np.array([float(e["dur"]) for e in events])
        self.is_span = np.array([e.get("cat") == "user_annotation" for e in events], dtype=bool)

    def at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span
        and the innermost op or runtime call that cover it."""
        import numpy as np

        covering = (self.start <= t) & (self.start + self.dur >= t)
        parts = []
        for kind in (self.is_span, ~self.is_span):
            idx = np.flatnonzero(covering & kind)
            if idx.size:
                parts.append(self.names[int(idx[np.argmin(self.dur[idx])])])
        return short_name(" / ".join(parts)) if parts else "no traced host call"
