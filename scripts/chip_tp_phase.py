"""``chip_smoke.py``'s tensor-parallel phase alone, with the two-epoch run it
is held to.

    python scripts/chip_tp_phase.py [--serving]

Builds the kernels, runs the two-epoch one-rank ``DOWNPOUR`` at phase 20's
depth (GPT-2 small's widths, 6 blocks, through B1-B3) and then the
tensor-parallel phase (phase 20: the same training over two gloo ranks
sharing the card with ``tp_shards=2`` against one rank's run of as many
epochs, ``fsdp=True`` alone against the
replicated two-rank run, the returned model through ``ModelPredictor``, and
the 2 x 2 NCCL grid, one rank a card, where the machine has 4 cards), each
printing ``chip_smoke.py``'s JSON lines; with ``--serving``, then the
serving phase (its bf16-pool case included).  Any failed gate raises.
``chip_smoke.py`` runs every phase; this is the tensor-parallel path and
its reference alone.  Needs a CUDA card.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_tp_phase: no CUDA device", file=sys.stderr)
        return 2
    from distkeras_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    chip_smoke.emit(phase="device", nvidia_smi=chip_smoke.CARD, count=torch.cuda.device_count(),
                    torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    _build.build_all()
    _, train_run = chip_smoke.tp_train(0, chip_smoke.TRAIN_EPOCHS)
    t1 = time.perf_counter()
    chip_smoke.tp_phase(0, train_run)
    t2 = time.perf_counter()
    if "--serving" in argv:
        chip_smoke.serving_phase(0)
    chip_smoke.emit(phase="timing", build_and_train_s=t1 - t0, tp_phase_s=t2 - t1,
                    serving_phase_s=time.perf_counter() - t2, card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
