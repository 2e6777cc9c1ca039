"""``chip_smoke.py``'s phases that hold captured CUDA graphs to eager, alone.

    python scripts/chip_graphs_phase.py [--seed 0] [--online]

Builds the kernels and runs, at the script's full widths: the staleness
phase (DynSGD over TextCNN, eager and with ``unroll=True``: one captured
step replayed once a step), the train phase (the remat phase's reference
without dropout), the remat/graph phase (GPT-2-small-wide ``DOWNPOUR``
with dropout: eager, ``remat``, captured windows and ``remat`` inside
captured windows) and the serving phase (the engine's decode, speculative
and prefill programs captured, held to the eager engine bit for bit, across
a hot swap too, and profiled both ways); with ``--online``, phase 27 too
(the serving tier's replicas and the online loop's retrains, capturing
from threads of one process).  Prints ``chip_smoke.py``'s JSON lines; any
failed gate raises.  ``chip_smoke.py`` runs every phase.  Needs a CUDA
card.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed for weights and inputs")
    parser.add_argument("--online", action="store_true", help="run phase 27 as well")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_graphs_phase: no CUDA device", file=sys.stderr)
        return 2
    from distkeras_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    chip_smoke.emit(phase="device", nvidia_smi=chip_smoke.CARD, count=torch.cuda.device_count(),
                    torch=torch.__version__, cuda=torch.version.cuda)
    seconds = {}
    t0 = time.perf_counter()
    _build.build_all()
    seconds["build"] = time.perf_counter() - t0
    timed = chip_smoke._timer(seconds, t0, "chip_graphs_phase")
    timed("staleness", chip_smoke.staleness_phase, args.seed)
    _, train_run = timed("train", chip_smoke.train_phase, args.seed)
    timed("remat_graph", chip_smoke.remat_graph_phase, args.seed, train_run)
    timed("serving", chip_smoke.serving_phase, args.seed)
    if args.online:
        timed("online", chip_smoke.online_phase, args.seed)
    chip_smoke.emit(phase="timing", seconds=seconds, wall_s=time.perf_counter() - t0,
                    card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
