"""``chip_smoke.py``'s pipeline phase alone.

    python scripts/chip_pp_phase.py [--cards-only]

Builds the kernels and runs phase 23: a ``StagedLM`` at GPT-2 small's
widths (6 of the 12 blocks as 2 stages of 3, 16 rows) under ``DOWNPOUR`` on one rank (the
sequential executor), and a one-stage ``PipelineEngine`` over the same 6
blocks in captured windows (``unroll=True``, over a one-rank NCCL group)
held bit for bit to its eager run; then ``pipeline_stages=2,
pp_microbatches=2`` on two gloo ranks sharing the card against the
one-rank run, replicated and with ``fsdp=True``, the trained model's greedy
decode sequential and pipelined over the two ranks, and a ``ServingEngine``
over it; where the machine has 4 cards, the 2 x 2 NCCL grid, one rank a
card, eager and again in captured windows (the schedule's collectives
inside the graphs), each captured run held bit for bit to its eager twin,
with steady tokens/s and peak GB a rank both ways.  Each prints
``chip_smoke.py``'s JSON lines; ``--cards-only`` leaves out the gloo pair
(a 4-card call for the NCCL grid and its references alone).  Any failed gate raises.
``chip_smoke.py`` runs every phase; this is the pipeline path and its
reference alone.  Needs a CUDA card.
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
        print("chip_pp_phase: no CUDA device", file=sys.stderr)
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
    chip_smoke.pipeline_phase(0, pair="--cards-only" not in argv)
    chip_smoke.emit(phase="timing", build_s=t1 - t0, pipeline_phase_s=time.perf_counter() - t1,
                    card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
