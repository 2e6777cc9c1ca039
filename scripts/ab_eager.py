"""The port's eager training speed, one source tree against another, on one card.

    python scripts/ab_eager.py --tree parent=DIR --tree change=. \
        [--order parent,change,change,parent] [--passes 5] [--out FILE]

Each entry of ``--order`` runs in a process of its own, with that tree's
``distkeras_tpu_torch`` first on ``sys.path``.  The process trains
``cifar_cnn_downpour`` as ``chip_smoke.py``'s epochs phase does (CIFARCNN,
per-worker batch 256, ``Downpour(16)``, SGD at lr 0.05 with momentum 0.9,
bf16 compute, 2 workers, 2 epochs of 4 windows, data drawn from
``--seed``), eagerly, through ``DOWNPOUR``.  Then it times ``--passes``
more passes of 2 epochs on the trained engine and state through
``WindowedEngine.run_epoch``, with the stats read back each epoch as the
trainer reads them.  It prints one JSON line per process: the trainer's
own s/step (first run, warm-up included) and each timed pass's s/step and
samples/s; then one summary line with each tree's median.  Compare two
trees only within one call: the steps are bound by the host, whose speed
differs between machines.  Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

WORKERS, BATCH, WINDOW, WINDOWS, EPOCHS = 2, 256, 16, 4, 2


def child(tree: str, seed: int, passes: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    import distkeras_tpu_torch as tdk
    from distkeras_tpu_torch.data import epoch_arrays
    from distkeras_tpu_torch.models import zoo

    where = os.path.dirname(os.path.abspath(tdk.__file__))
    if not where.startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported distkeras_tpu_torch from {where}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    class Downpour(tdk.DOWNPOUR):
        def _fit(self, *args, **kwargs):
            self.fit_result = super()._fit(*args, **kwargs)
            return self.fit_result

    rows = WORKERS * WINDOWS * WINDOW * BATCH
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(size=(rows, 32, 32, 3), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, rows)]
    model = zoo.CIFARCNN(generator=torch.Generator().manual_seed(seed))
    trainer = Downpour(model, loss="categorical_crossentropy", metrics=(), batch_size=BATCH,
                       seed=seed, compute_dtype="bfloat16", device="cuda",
                       worker_optimizer=("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
                       num_workers=WORKERS, communication_window=WINDOW, num_epoch=EPOCHS)
    trainer.train(tdk.from_numpy(x, y))
    torch.cuda.synchronize()
    steps = EPOCHS * WINDOWS * WINDOW * WORKERS
    first = trainer.get_history()["training_time"] / steps

    engine, state, _ = trainer.fit_result
    xs, ys = engine.shard_batches(*epoch_arrays(x, y, WORKERS, BATCH, WINDOW))
    per_step = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EPOCHS):
            state, stats = engine.run_epoch(state, xs, ys)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) / steps)
    if not np.isfinite(stats["loss"]).all():
        raise AssertionError(f"loss not finite: {stats['loss']}")
    return dict(trainer_seconds_per_step=first, seconds_per_step=per_step,
                samples_per_s=[WORKERS * BATCH / s for s in per_step],
                median_seconds_per_step=statistics.median(per_step))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: a source tree holding distkeras_tpu_torch/")
    parser.add_argument("--order", default="parent,change,change,parent",
                        help="comma-separated tree names, one process each, in this order")
    parser.add_argument("--passes", type=int, default=5, help="timed passes of 2 epochs")
    parser.add_argument("--seed", type=int, default=0, help="seed for weights and data")
    parser.add_argument("--out", help="also append every line to this file")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.child:
        print(json.dumps(child(args.child, args.seed, args.passes)), flush=True)
        return 0
    trees = {name: os.path.abspath(d) for name, d in (t.split("=", 1) for t in args.tree)}
    lines, medians = [], {}
    for name in args.order.split(","):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", trees[name],
                              "--seed", str(args.seed), "--passes", str(args.passes)],
                             capture_output=True, text=True, check=True, timeout=900,
                             cwd=trees[name])
        row = dict(tree=name, **json.loads(out.stdout.strip().splitlines()[-1]))
        medians.setdefault(name, []).extend(row["seconds_per_step"])
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    summary = {name: dict(median_seconds_per_step=statistics.median(v),
                          median_samples_per_s=WORKERS * BATCH / statistics.median(v),
                          passes=len(v)) for name, v in medians.items()}
    lines.append(json.dumps(dict(summary=summary, order=args.order, config="cifar_cnn_downpour",
                                 workers=WORKERS, batch_size=BATCH, window=WINDOW)))
    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
