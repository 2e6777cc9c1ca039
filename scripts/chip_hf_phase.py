"""``chip_smoke.py``'s hf_telemetry phase alone.

    python scripts/chip_hf_phase.py

Builds the kernels and runs phase 25: a GPT-2-small checkpoint's layout
(``GPT2LMHeadModel``'s state dict, random from seed 0) converted by
``gpt2_state_to_staged`` into a ``PretrainedStagedLM`` of 2 stages, its
forward on the card against the CPU, the train phase's one-rank
``DOWNPOUR`` over it with the training telemetry off and then on
(``DISTKERAS_TELEMETRY``, ``DISTKERAS_DYNAMICS`` with the ``warn``
watchdog, ``profile_dir``) and a third time under the runtime sanitizer,
strict; a sync planted inside a strict transfer guard; and the fine-tuned
model served over HTTP by ``install_http_endpoint`` on the flight deck's
exporter at 127.0.0.1, strict and billed to two tenants (``/ledger``,
``/healthz``, ``/slo``), printing ``chip_smoke.py``'s JSON line.  Any failed gate raises.
``chip_smoke.py`` runs every phase; this is the HuggingFace and telemetry
path alone.  Needs a CUDA card.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main(argv) -> int:
    del argv
    if not torch.cuda.is_available():
        print("chip_hf_phase: no CUDA device", file=sys.stderr)
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
    chip_smoke.hf_telemetry_phase(0)
    chip_smoke.emit(phase="timing", build_s=t1 - t0, hf_telemetry_phase_s=time.perf_counter() - t1,
                    card=chip_smoke.CARD)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
