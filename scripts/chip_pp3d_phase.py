"""``chip_smoke.py``'s pipeline_3d phase alone.

    python scripts/chip_pp3d_phase.py [--cards-only]

Builds the kernels and runs phase 24: phase 23's ``StagedLM`` at GPT-2
small's widths, cut to 6 blocks as 2 stages of 3 and 16 rows, under ``DOWNPOUR`` on one rank
(the sequential executor, the reference), then four gloo ranks sharing the
card on the pipeline engine's 1 x 2 x 2 grids: ``tp_shards=2``, with
``fsdp=True``, and ``seq_shards=2`` with the model built ``seq_axis="seq"``,
each against the one-rank run; where the machine has 4 cards, both grids
over NCCL, one rank a card, eager and again in captured windows
(``unroll=True``: the stage shifts, the model axis's gathers and psums or
the ring's hops, the gradient sums and the commit inside the graphs), each
captured run held bit for bit to its eager twin, with steady tokens/s and
peak GB a rank both ways.  Each prints ``chip_smoke.py``'s JSON lines;
``--cards-only`` leaves out the gloo ranks (a 4-card call for the NCCL
grids alone).  Any failed gate raises.  ``chip_smoke.py`` runs every
phase; this is the 3-D pipeline paths and their reference alone.  Needs a
CUDA card.
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
        print("chip_pp3d_phase: no CUDA device", file=sys.stderr)
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
    ref = chip_smoke._pp_one_rank(0, 1, chip_smoke._pp3d_model())
    chip_smoke.emit(phase="pipeline", case="one_rank", loss=ref["loss"],
                    tokens_per_s=ref["tokens_per_s"], peak_memory_gb=ref["peak_memory_gb"],
                    launches_b1_b2_b3=ref["launches"], block_bytes=ref["block_bytes"],
                    card=chip_smoke.CARD)
    t2 = time.perf_counter()
    chip_smoke.pipeline_3d_phase(0, ref, pair="--cards-only" not in argv)
    chip_smoke.emit(phase="timing", build_s=t1 - t0, one_rank_s=t2 - t1,
                    pipeline_3d_phase_s=time.perf_counter() - t2, card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
