"""The readers of the serving engine's own timings
(``serve.queue_wait_p95_ms``, ``serve.prefill_ms``,
``serve.decode_device_ms_per_token``) on synthetic requests worked out by
hand: the window's cut, the nearest rank, the sums; and on a program whose
results carry no timings, no value.  Then one traced serving run on the CPU
at tiny widths reads all three."""

import dataclasses
import types

import numpy as np
import pytest

from portbench import engine_timings, harness
from portbench.traffic import Request

MANIFEST = harness.load_json(harness.ROOT / "BENCHMARK.json")
SERVE = harness.resolve(MANIFEST, "gpt2s-serve-open")
READERS = ("serve.queue_wait_p95_ms", "serve.prefill_ms", "serve.decode_device_ms_per_token")
#: the window's open on the host clock, and the run's seconds: with the
#: cell's trace at 0.4 the stretch starts 40 s after the open
OPEN, SECONDS = 1000.0, 100.0
STRETCH = OPEN + SERVE.traffic["trace"]["at"] * SECONDS


@dataclasses.dataclass
class Result:
    """What the readers need of a ``GenerateResult``."""

    tokens: list
    finish_reason: str = "length"
    latency_s: float = 1.0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    device_s: float = 0.0
    decode_device_s: float = 0.0


def offered(due_s, *, latency_s=1.0, tokens=4, max_new=None, result=True, **timings):
    """A synthetic request of the window, due ``due_s`` after the open,
    submitted when due and answered ``latency_s`` later."""
    driver = harness.driver_module("serve")
    max_new = tokens if max_new is None else max_new
    item = driver.Offered(Request(due_s, np.zeros(3, np.int64), max_new), OPEN + due_s)
    item.submit_t = OPEN + due_s
    if result:
        item.result = Result(tokens=[1] * tokens, latency_s=latency_s, **timings)
    return item


def run_of(items):
    run = harness.Run(cell=SERVE, seed=1, seconds=SECONDS, traced=True, t0=0.0)
    run.facts["offered"] = items
    return run


def read(name, run):
    return harness.metric_reader(name).read(run)


def test_the_manifest_lists_the_readers():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"], m["workloads"]) == (
            "ms", "lower", "program_counter", "serve_ttft_p95_ms", ["gpt2s-serve-open"])


def test_the_window_cut():
    keep = offered(5.0, latency_s=2.0, queue_wait_s=0.004, prefill_s=0.002)
    items = [
        keep,
        offered(-1.0, queue_wait_s=9.0, prefill_s=9.0),  # due before the open
        offered(39.5, latency_s=1.0, queue_wait_s=9.0, prefill_s=9.0),  # ends in the stretch
        offered(38.0, latency_s=2.0, queue_wait_s=0.006, prefill_s=0.004),  # ends as it starts
        offered(10.0, tokens=2, max_new=4, queue_wait_s=9.0),  # cut short: not complete
        offered(11.0, result=False),  # never answered
    ]
    got = engine_timings.window_results(run_of(items))
    assert got == [keep.result, items[3].result]
    assert read("serve.prefill_ms", run_of(items)) == pytest.approx(3.0)


@pytest.mark.parametrize("n,rank", [(20, 19), (21, 20), (40, 38), (1, 1)])
def test_the_p95_takes_the_nearest_rank(n, rank):
    # waits of 1 .. n ms, shuffled: the p95 is the ceil(0.95 n)-th smallest
    waits = np.random.default_rng(n).permutation(np.arange(1, n + 1))
    items = [offered(float(i), queue_wait_s=1e-3 * float(w)) for i, w in enumerate(waits)]
    assert read("serve.queue_wait_p95_ms", run_of(items)) == pytest.approx(float(rank))


def test_decode_device_per_token_and_prefill_mean():
    items = [offered(1.0, tokens=5, prefill_s=0.002, device_s=0.010, decode_device_s=0.008),
             offered(2.0, tokens=1, prefill_s=0.004, device_s=0.003, decode_device_s=0.0),
             offered(3.0, tokens=3, prefill_s=0.003, device_s=0.006, decode_device_s=0.004)]
    run = run_of(items)
    # 12 ms of decode shares over 4 + 0 + 2 tokens after the first
    assert read("serve.decode_device_ms_per_token", run) == pytest.approx(2.0)
    assert read("serve.prefill_ms", run) == pytest.approx(3.0)


def test_a_program_without_timings_reads_nothing():
    item = offered(1.0)
    item.result = types.SimpleNamespace(tokens=[1] * 4, finish_reason="length", latency_s=1.0,
                                        ttft_s=0.5)
    for items in ([item], []):
        for name in READERS:
            assert read(name, run_of(items)) is None
    assert read("serve.decode_device_ms_per_token", run_of([offered(1.0, tokens=1)])) is None


def test_a_traced_serving_run_reads_the_engine_timings(tiny_run):
    run = tiny_run("gpt2s-serve-open", seed=2**31 + 7, seconds=5.0, traced=True)
    harness.driver_module("serve").run(run)
    results = engine_timings.window_results(run)
    assert results, "no request finished before the stretch"
    for r in results:
        assert abs(r.queue_wait_s + r.prefill_s - r.ttft_s) < 1e-6
    assert read("serve.queue_wait_p95_ms", run) >= 0.0
    assert read("serve.prefill_ms", run) > 0.0
    assert read("serve.decode_device_ms_per_token", run) > 0.0
