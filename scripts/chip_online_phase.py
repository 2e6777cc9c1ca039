"""``chip_smoke.py``'s online phase alone.

    python scripts/chip_online_phase.py [--seed 0]

Builds the kernels and runs phase 27 at GPT-2 small's widths and depth:
two ``ServingEngine`` replicas behind a ``ServingTier``, failover under a
seeded ``kill_replica`` (greedy tokens held to each request served alone
by the top-two-gap rule, sampled ones exactly, billed once); then the
online loop, served traffic captured by a ``TrafficLog`` behind
``install_tier_endpoint``, each window retrained by ``WindowScheduler``
through ``DOWNPOUR`` (B1-B3), a rotted step rejected at swap time and the
next rolled into both replicas bit for bit with requests in flight.
Prints ``chip_smoke.py``'s JSON line; any failed gate raises.
``chip_smoke.py`` runs every phase; this is the online path alone.  Needs a
CUDA card.
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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_online_phase: no CUDA device", file=sys.stderr)
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
    chip_smoke.online_phase(args.seed)
    chip_smoke.emit(phase="timing", build_s=t1 - t0, online_phase_s=time.perf_counter() - t1,
                    card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
