"""``chip_smoke.py``'s mixture-of-experts phase alone.

    python scripts/chip_moe_phase.py [--cards-only]

Builds the kernels and runs phase 22: ``MoETransformerClassifier`` at
switch-base-8's widths under ``DOWNPOUR`` on one rank (B1-B3 in every
block's attention, a step held to the CPU, the trained model through
``ModelPredictor``), then expert-parallel (``tp_shards=2`` with
``expert_partition(8)``) on two gloo ranks sharing the card against it (and
the NCCL grid, one rank a card, where the machine has several cards: 2 x 2
with 4, 1 x 2 with 2 or 3, eager and in captured windows), each printing
``chip_smoke.py``'s JSON lines; ``--cards-only`` leaves out the gloo pair
(a call on several cards for the NCCL grid and its one-rank reference
alone).  Any failed gate raises.
``chip_smoke.py`` runs every phase; this is the MoE path and its reference
alone.  Needs a CUDA card.
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
        print("chip_moe_phase: no CUDA device", file=sys.stderr)
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
    t1 = time.perf_counter()
    chip_smoke.moe_phase(0, pair="--cards-only" not in argv)
    chip_smoke.emit(phase="timing", build_s=t1 - t0, moe_phase_s=time.perf_counter() - t1,
                    card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
