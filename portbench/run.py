"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and traced seconds
and a breakdown of the trace.  Either way the run checks what its timed
path produced against the plain reference (``portbench/reference``) and
prints each compared number beside its limit, last on standard error and
last in the result line.  A run that finds no card, or fewer than the cell
asks for, exits 2 and prints no result; one that finds JAX or the JAX
package loaded once the window has closed exits 3.
"""

import time

#: process start, as near as Python gets to it: set-up is timed from here
T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import harness

    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.resolve(manifest, args.workload)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2
    harness.set_cache_environment()
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                      traced=bool(args.trace), t0=T0)
    try:
        run.device = harness.require_cards(cell.chips)
    except harness.NoCard as exc:
        print(f"portbench: {exc}; no result", file=sys.stderr)
        return 2
    print(f"card: {harness.card_line()}", file=sys.stderr)
    import torch

    harness.driver_module(cell.traffic["driver"]).run(run)

    metrics = {}
    if run.traced:
        for entry in cell.per_layer:
            value = harness.per_layer_module(run, entry["name"]).read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": harness.number(value), "unit": entry["unit"]}
    else:
        for entry in cell.end_to_end:
            metrics[entry["name"]] = {"value": harness.number(run.end_to_end[entry["name"]]),
                                      "unit": entry["unit"]}
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: {', '.join(found)} loaded in the measuring process; no result",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
              "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    breakdown = None
    if run.traced:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        breakdown = run.trace.breakdown()
    harness.print_checks(run)
    print(harness.result_line(run, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
