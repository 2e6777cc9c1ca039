"""The bf16 tolerance of ``chip_smoke.py``'s mesh phase, measured on the CPU.

    python scripts/mesh_tolerance.py [--batch 16] [--seed 0] [--threads 4]

The mesh phase holds ``cifar_cnn_downpour`` (CIFARCNN, ``Downpour(16)``,
SGD at lr 0.05 with momentum 0.9, bf16 compute) with 4 workers over two
ranks sharing the card against one rank with 4 workers.  The two runs
differ only in the order of the commit's sum, ``(w0 + w1) + (w2 + w3)``
against ``w0 + w1 + w2 + w3``, and bf16 steps carry that difference on.
This script runs the same comparison on the CPU (two gloo ranks spawned as
the phase spawns them) with the card run's commit pattern (window 16, 2
windows an epoch, 2 epochs) at a per-worker batch of ``--batch`` (the
card's 256 is too slow here; batch 4 diverges at this learning rate) and
prints one JSON line: the f32 first window's and the bf16 run's distance
from one rank.  ``MESH_BF16_*`` in ``chip_smoke.py`` were set from it.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=4)
    args = parser.parse_args(argv)

    import torch

    import chip_smoke

    torch.set_num_threads(args.threads)
    chip_smoke.ZOO_DEVICE = "cpu"
    chip_smoke.ZOO_WINDOW, chip_smoke.EPOCHS_WINDOWS = 16, 4
    chip_smoke.ZOO_CONFIGS = [c[:4] + (args.batch,) + c[5:] for c in chip_smoke.ZOO_CONFIGS]
    one_rank = chip_smoke._mesh_runs(args.seed)
    with tempfile.TemporaryDirectory() as workdir:
        two_ranks = chip_smoke._spawn_mesh(args.seed, 2, "gloo", False, workdir)
    row, failures = chip_smoke._mesh_versus(two_ranks, one_rank)
    print(json.dumps(dict(batch=args.batch, seed=args.seed, workers=chip_smoke.MESH_WORKERS,
                          window=16, windows_per_epoch=2, epochs=chip_smoke.ZOO_EPOCHS,
                          f32_first_window=row["f32_vs_one_rank"],
                          bf16=row["bf16_vs_one_rank"], bf16_loss=row["bf16_loss"],
                          num_updates=row["num_updates"], failures=failures)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
