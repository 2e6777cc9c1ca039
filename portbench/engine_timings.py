"""The serving engine's own timings of each request, which the per-layer
metrics ``serve.queue_wait_p95_ms``, ``serve.prefill_ms`` and
``serve.decode_device_ms_per_token`` read from the results of a serving
window (``run.facts["offered"]``).

Each result of the port's ``ServingEngine`` carries ``queue_wait_s`` (its
entry into the admission queue to the start of its prefill), ``prefill_s``
(from there to its first token read back), ``device_s`` (its prefill
programs' device seconds plus an even share of each decode step it was
decoded in) and ``decode_device_s`` (the steps' shares alone).  The
requests read are the complete ones due at or after the window's open that
finished before the traced stretch started: the profiler slows the host
loop, so the stretch is left out, as the engine's counters leave it out.
A program whose results carry no such timings gives no requests, and each
reader then no value.
"""

from __future__ import annotations

from typing import List

#: the result fields the readers need
FIELDS = ("queue_wait_s", "prefill_s", "device_s", "decode_device_s")


def window_results(run) -> List:
    """The results of ``run``'s requests that the engine timings are read
    from (empty where the program does not time them)."""
    offered = run.facts.get("offered") or []
    if not offered:
        return []
    first = offered[0]
    open_t = first.due_t - first.request.due_s
    stretch_t = open_t + run.cell.traffic["trace"]["at"] * run.seconds
    out = []
    for o in offered:
        if not o.ok or o.due_t < open_t:
            continue
        r = o.result
        if not all(hasattr(r, name) for name in FIELDS):
            return []
        if o.submit_t + r.latency_s <= stretch_t:
            out.append(r)
    return out
