"""The readings that a cell's correctness limits are set from, on the card.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13 [--seconds 5]

For each seed, one line of JSON with:

* ``program``: the numbers a run of the cell compares (a run of the cell's
  driver with a short window: training compares its first window, which no
  window length changes; serving compares a sample of the window's
  requests);
* ``control``: the same numbers of the reference computed one precision
  below the configuration's and put in the program's place: float8 e4m3
  products for a bfloat16 training cell, TF32 products for a float32
  serving cell (the logit gap of the token TF32 puts first, at each position
  of the same prompts and served tokens);
* the faults a cell can have, planted in the reference put in the
  program's place: training, half of each batch left out (the mean over
  the rest) and a step that returns its state unchanged (the start's loss,
  no moment, no change); serving, one served token a request altered where
  it is produced.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _train(run):
    import torch

    from portbench import checks
    from portbench.drivers import train as driver

    config, traffic, device = run.cell.config, run.cell.traffic, run.device
    driver.run(run)
    out = {"program": run.facts["numbers"]}
    ref = driver.reference_window(config, traffic, run.seed, device)
    faults = {
        "control": driver.reference_window(config, traffic, run.seed, device, mode="fp8"),
        "half_batch": driver.reference_window(config, traffic, run.seed, device,
                                              rows=slice(0, traffic["batch_size"] // 2)),
    }
    # a step that returns its state unchanged: the weights stay at the start
    # (the loss of each step is the start's), no moment and no change
    still = driver.reference_window(config, traffic, run.seed, device, lr=0.0)
    faults["unchanged"] = {"loss": still["loss"],
                           "mu": {k: torch.zeros_like(v) for k, v in still["mu"].items()},
                           "change": {k: torch.zeros_like(v) for k, v in still["change"].items()}}
    for name, got in faults.items():
        out[name] = checks.train_numbers(got, ref)
    return out


def _serve(run):
    import torch

    from portbench import traffic as gen
    from portbench import weights as wmod
    from portbench.drivers import serve as driver
    from portbench.reference.decode import control_gaps, served_gaps
    from portbench.reference.products import products

    config, traffic, device = run.cell.config, run.cell.traffic, run.device
    driver.run(run)
    out = {"program": {k: v["value"] for k, v in run.checks.items()}}
    done = [o for o in run.facts["offered"] if o.ok]
    picks = gen.sample_indices(run.seed, [len(o.result.tokens) for o in done],
                               traffic["check"]["sample"])
    w = wmod.make(config, run.seed, device)
    control = altered = 0.0
    positions = 0
    for i in picks:
        o = done[i]
        prompt, tokens = o.request.prompt.tolist(), list(o.result.tokens)
        control = max(control, float(control_gaps(w, config, prompt, tokens, "tf32").max()))
        positions += len(tokens)
    with products("float32") as mm:
        for i in picks:
            o = done[i]
            tokens = list(o.result.tokens)
            j = len(tokens) // 2
            tokens[j] = (tokens[j] + 1) % config["vocab_size"]
            altered = max(altered, float(served_gaps(w, config, o.request.prompt.tolist(),
                                                     tokens, mm).max()))
    out["control"] = {"logit_gap": control, "positions": positions}
    out["altered_token"] = {"logit_gap": altered}
    del w
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from portbench import harness

    cell = harness.resolve(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    harness.set_cache_environment()
    device = harness.require_cards(cell.chips)
    print(f"card: {harness.card_line()}", file=sys.stderr)
    reading = _train if cell.traffic["driver"] == "train" else _serve
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = harness.Run(cell=cell, seed=seed, seconds=args.seconds, traced=False, t0=t0)
        run.device = device
        out = {"workload": cell.name, "seed": seed, **reading(run)}
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        harness.free_memory(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
