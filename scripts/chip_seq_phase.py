"""``chip_smoke.py``'s sequence-parallel phase alone, with the one-rank run it
is held to.

    python scripts/chip_seq_phase.py

Builds the kernels, runs the phase's reference (its GPT-2-small
``DOWNPOUR``, cut to 6 blocks and one epoch, at one rank, through B1-B3)
and then the sequence-parallel phase (the same run over two gloo ranks
sharing the card with
``seq_shards=2``, ``fsdp=True``, the classifier at two ranks, the returned
twin through ``ModelPredictor``, and the 2 x 2 NCCL grid, one rank a card,
where the machine has 4 cards), each printing ``chip_smoke.py``'s JSON
lines; any failed gate raises.  ``chip_smoke.py`` runs every phase; this is
the sequence-parallel path and its reference alone, for a machine with 4
cards.  Needs a CUDA card.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_seq_phase: no CUDA device", file=sys.stderr)
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
    _, reference = chip_smoke.seq_train(0, 1)
    t1 = time.perf_counter()
    chip_smoke.seq_phase(0, reference)
    chip_smoke.emit(phase="timing", build_and_reference_s=t1 - t0,
                    seq_phase_s=time.perf_counter() - t1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
