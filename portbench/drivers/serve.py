"""Serving cells: the port's ``ServingEngine`` under open-loop traffic.

Set-up builds the engine over the benchmark's weights, then captures every
step program the traffic will use: one request a prefill bucket that the
mix's prompt lengths reach (each also runs the decode step), waited for in
turn.  The window then offers the seed's schedule (:func:`portbench.
traffic.schedule`): each request is submitted when it is due, from this
thread, whatever the engine is doing.  A request's time to first token is
counted from when it was due, so the generator's lateness counts; one that
is refused, aborted or never answered is missing (``failed``) and counts as
infinitely late.  Tokens a second are the engine's generated tokens
between the window's open and close.  After the close every request due in
the window is waited for, up to a minute.

The check: a sample of the finished requests drawn from the seed, the
longest among them, each replayed through the reference's full forward
(:mod:`portbench.reference.decode`).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Optional

import torch

from portbench import harness, program, tracing
from portbench import traffic as gen
from portbench import weights as wmod
from portbench.reference.decode import served_gaps
from portbench.reference.products import products

#: how long past the close the driver waits for the window's requests
DRAIN_SECONDS = 60.0
#: the time to first token counted for a missing request, in seconds
MISSING = math.inf


class Offered:
    """One request of the window: when it was due and submitted, and its
    engine handle (None when the engine refused it)."""

    __slots__ = ("request", "due_t", "submit_t", "pending", "result")

    def __init__(self, request, due_t):
        self.request, self.due_t = request, due_t
        self.submit_t = None
        self.pending = None
        self.result = None

    @property
    def ok(self) -> bool:
        r = self.result
        return (r is not None and r.finish_reason == "length"
                and len(r.tokens) == self.request.max_new)

    @property
    def ttft_s(self) -> float:
        if self.result is None or not self.result.tokens:
            return MISSING
        return self.submit_t - self.due_t + self.result.ttft_s


def build_engine(config: dict, traffic: dict, weights, device):
    """The port's engine over the benchmark's weights, and the metrics
    registry of its own that it reports to."""
    from distkeras_tpu_torch.serving import ServingEngine
    from distkeras_tpu_torch.telemetry.metrics import Registry

    module = program.build(config)
    program.check_layout(module, wmod.table(config))
    knobs, registry = traffic["engine"], Registry()
    engine = ServingEngine(module, weights, num_slots=knobs["num_slots"],
                           page_size=knobs["page_size"], queue_size=knobs["queue_size"],
                           registry=registry, device=device)
    return engine, registry


def warm_up(engine, traffic: dict, vocab: int) -> None:
    """Capture the prefill of every bucket the mix's prompts reach, and the
    decode step."""
    from distkeras_tpu_torch.serving import GenerateRequest

    lo, hi = traffic["prompt"]["min"], traffic["prompt"]["max"]
    used, below = [], 0
    for width in engine.prefill_buckets:
        if width >= lo and below < hi:
            used.append(width)
        below = width
    for width in used:
        n = min(width, hi)
        prompt = [(7 * i) % vocab for i in range(n)]
        result = engine.submit(GenerateRequest(prompt=prompt, max_new_tokens=2)).result(120)
        if result is None or result.finish_reason != "length":
            raise RuntimeError(f"warm-up request of {n} tokens did not finish: {result}")
    return used


def counters(registry) -> dict:
    """The engine's counters and histogram sums the window reads."""
    from distkeras_tpu_torch.serving.engine import serving_metrics

    m = serving_metrics(registry)
    return {"tokens": m["tokens"].value, "padded": m["prefill_padded"].value,
            "step_sum": m["token_latency"].sum, "step_count": m["token_latency"].count}


def serve_window(engine, registry, schedule, seconds: float, stretch: Optional[tracing.Stretch] = None,
                 stretch_at: float = 0.0, stretch_seconds: float = 0.0):
    """Offer ``schedule`` open-loop for ``seconds``; returns ``(offered,
    marks, t0)``: the requests, the engine's counters at the window's open,
    at its close and (with ``stretch``) at the stretch's start, and the
    open's clock.  With ``stretch``, profile ``stretch_seconds`` from
    ``stretch_at`` seconds into the window."""
    from distkeras_tpu_torch.serving import GenerateRequest
    from distkeras_tpu_torch.serving.frontend import QueueFull

    marks = {"open": counters(registry)}
    t0 = time.perf_counter()
    offered = []

    def drive(until):
        """Start or stop the traced stretch on the way to ``until``."""
        start, stop = t0 + stretch_at, t0 + stretch_at + stretch_seconds
        if not stretch.active and stretch.path is None and until >= start:
            time.sleep(max(0.0, start - time.perf_counter()))
            marks["stretch"] = counters(registry)
            marks["stretch_t"] = time.perf_counter()
            stretch.start()
        if stretch.active and until >= stop:
            time.sleep(max(0.0, stop - time.perf_counter()))
            stretch.stop()

    for req in schedule:
        due = t0 + req.due_s
        if stretch is not None:
            drive(due)
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        item = Offered(req, due)
        item.submit_t = time.perf_counter()
        try:
            with tracing.span("engine.submit"):
                item.pending = engine.submit(GenerateRequest(
                    prompt=req.prompt.tolist(), max_new_tokens=req.max_new))
        except QueueFull:
            pass
        offered.append(item)
    if stretch is not None:
        drive(t0 + seconds)
    wait = t0 + seconds - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    marks["close"] = counters(registry)
    if stretch is not None and stretch.active:
        stretch.stop()
    deadline = t0 + seconds + DRAIN_SECONDS
    for item in offered:
        if item.pending is not None:
            item.result = item.pending.result(max(0.0, deadline - time.perf_counter()))
    return offered, marks, t0


def check_sample(config, offered, seed: int, k: int, device):
    """The widest logit gap over a sample of ``k`` finished requests (the
    longest among them), and how many tokens it covered."""
    done = [o for o in offered if o.ok]
    picks = gen.sample_indices(seed, [len(o.result.tokens) for o in done], k)
    w = wmod.make(config, seed, device)
    widest, tokens = 0.0, 0
    with products("float32") as mm:
        for i in picks:
            o = done[i]
            gaps = served_gaps(w, config, o.request.prompt.tolist(), o.result.tokens, mm)
            widest = max(widest, float(gaps.max()))
            tokens += len(o.result.tokens)
    return widest, tokens


def run(run: harness.Run) -> None:
    config, traffic, device = run.cell.config, run.cell.traffic, run.device
    weights = wmod.make(config, run.seed, device)
    engine, registry = build_engine(config, traffic, weights, device)
    del weights
    schedule = gen.schedule(run.seed, traffic, config["vocab_size"], run.seconds)
    try:
        warm_up(engine, traffic, config["vocab_size"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run.end_to_end["setup_s"] = time.perf_counter() - run.t0
        print(f"setup_s {run.end_to_end['setup_s']!r}", file=sys.stderr)
        stretch = tracing.Stretch() if run.traced else None
        offered, marks, t0 = serve_window(
            engine, registry, schedule, run.seconds, stretch,
            traffic["trace"]["at"] * run.seconds, traffic["trace"]["seconds"])
        run.memory_peak_bytes = harness.memory_peak(device)
    finally:
        engine.stop()
    del engine
    harness.free_memory(device)

    missing = [o for o in offered if not o.ok]
    run.attempted, run.failed = len(offered), len(missing)
    ttfts = [o.ttft_s for o in offered]
    p95 = gen.percentile(ttfts, 95)
    tokens = marks["close"]["tokens"] - marks["open"]["tokens"]
    run.end_to_end["serve_tokens_per_s"] = tokens / run.seconds
    run.end_to_end["serve_ttft_p95_ms"] = 1e3 * p95 if math.isfinite(p95) else math.inf
    # the engine's own counters are read up to the traced stretch, whose
    # profiler slows the host loop
    end = marks.get("stretch_t", t0 + run.seconds)
    prefilled = sum(len(o.request.prompt) for o in offered
                    if o.result is not None and o.result.tokens
                    and o.submit_t + o.result.ttft_s <= end)
    run.facts.update(window=(marks["open"], marks.get("stretch", marks["close"])),
                     prompt_tokens=prefilled, offered=offered)
    if run.traced:
        run.trace = tracing.summarize(stretch.path)
        harness.measure_per_layer(run)

    widest, covered = check_sample(config, offered, run.seed, traffic["check"]["sample"], device)
    run.check("logit_gap", widest, run.cell.limits["checks"]["logit_gap"]["limit"])
    # a run whose sample covers too few tokens (requests lost) has not shown
    # its outputs right: the shortfall must be 0
    need = traffic["check"]["min_tokens"]
    run.check("tokens_short", max(0, need - covered),
              run.cell.limits["checks"]["tokens_short"]["limit"])
