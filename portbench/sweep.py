"""The serving rate sweep: the highest rate a serving cell's engine
sustains, found once on the card to fix the cell's rate.

    python3 -m portbench.sweep --workload gpt2s-serve-open --seed 5 --seconds 20 --rates 6 8 10

One engine, warmed once; for each rate, one open-loop window of the cell's
mix at that rate, drained before the next.  Each line: the rate, requests,
generated tokens a second, time to first token (p50, p95, max, in ms, from
the due time), the generator's worst lateness, the requests still queued at
the close, and the p95 of the first and of the last third of the window's
requests: a queue that grows through the window shows as a last third far
above the first.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    from portbench import harness

    cell = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    harness.set_cache_environment()
    device = harness.require_cards(cell.chips)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    from portbench import traffic as gen
    from portbench import weights as wmod
    from portbench.drivers import serve as driver

    config, traffic = cell.config, cell.traffic
    engine, registry = driver.build_engine(config, traffic, wmod.make(config, args.seed, device),
                                           device)
    try:
        driver.warm_up(engine, traffic, config["vocab_size"])
        for rate in args.rates:
            schedule = gen.schedule(args.seed, traffic, config["vocab_size"], args.seconds, rate)
            offered, marks, t0 = driver.serve_window(engine, registry, schedule, args.seconds)
            before, after = marks["open"], marks["close"]
            close = t0 + args.seconds
            ttft = [o.ttft_s for o in offered]
            third = max(1, len(offered) // 3)
            queued = sum(1 for o in offered if o.ttft_s == driver.MISSING
                         or o.submit_t + o.result.ttft_s > close)
            print(json.dumps({
                "rate": rate, "requests": len(offered),
                "failed": sum(1 for o in offered if not o.ok),
                "tokens_per_s": (after["tokens"] - before["tokens"]) / args.seconds,
                "ttft_p50_ms": 1e3 * gen.percentile(ttft, 50),
                "ttft_p95_ms": 1e3 * gen.percentile(ttft, 95),
                "ttft_max_ms": 1e3 * max(ttft),
                "p95_first_third_ms": 1e3 * gen.percentile(ttft[:third], 95),
                "p95_last_third_ms": 1e3 * gen.percentile(ttft[-third:], 95),
                "queued_at_close": queued,
                "lateness_max_ms": 1e3 * max(o.submit_t - o.due_t for o in offered),
                "decode_step_ms": 1e3 * (after["step_sum"] - before["step_sum"])
                / max(1, after["step_count"] - before["step_count"]),
            }), flush=True)
            time.sleep(1.0)
    finally:
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
