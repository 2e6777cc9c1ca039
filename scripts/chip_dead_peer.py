"""What a captured training window does when a peer dies before its replay.

    python scripts/chip_dead_peer.py [--wait SECONDS] [--logdir DIR]

Needs two CUDA cards.  Spawns two NCCL ranks, one a card, each training a
``WindowedEngine`` (a small ``TransformerLM``, one worker a rank,
``Downpour``) in captured windows (``unroll=True``): every replay holds the
commit's all-reduce.  Rank 1 raises before its third replay (the first
epoch's two windows are one captured graph, replayed twice) and its process
ends; rank 0 goes on.  A replayed collective has no NCCL watchdog,
so rank 0's replay waits for rank 1 for ever: the script waits ``--wait``
seconds (default 60), has rank 0 dump every thread's stack
(``faulthandler`` on ``SIGUSR1``), kills it, and prints one JSON line with
each rank's exit, how long rank 0 ran past rank 1's end and where it was
blocked (each rank's output is kept in ``--logdir`` when given).  The
kernels are built before the ranks start.  The serving mesh bounds this
wait (``utils.graphs.wait_bounded`` after each replay, with its plan
timeout); a training epoch has no such deadline, so this script records
what happens there instead.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LM = dict(vocab_size=23, dim=64, heads=4, num_layers=2, max_len=32)
WINDOWS, WINDOW, BATCH, EPOCHS = 2, 2, 4, 3


def rank_main(rank: int, init: str) -> int:
    import faulthandler

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from distkeras_tpu_torch.algorithms import Downpour
    from distkeras_tpu_torch.models import TorchModel, TransformerLM
    from distkeras_tpu_torch.parallel import WindowedEngine, make_mesh

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init, world_size=2, rank=rank)
    model = TransformerLM(**LM, generator=torch.Generator().manual_seed(1))
    engine = WindowedEngine(TorchModel(model), "token_crossentropy",
                            ("adam", {"learning_rate": 1e-3}), Downpour(WINDOW), num_workers=2,
                            metrics=(), mesh=make_mesh(), unroll=True)
    if rank == 1:
        replay = WindowedEngine._replay

        def failing(self, *args, **kwargs):
            if self.graph_stats["replays"] >= WINDOWS:
                raise RuntimeError("rank 1 fails before its replay")
            return replay(self, *args, **kwargs)

        WindowedEngine._replay = failing
    n = 2 * WINDOWS * WINDOW * BATCH
    start = np.random.default_rng(0).integers(0, LM["vocab_size"], (n, 1))
    x = (start + np.arange(LM["max_len"])) % LM["vocab_size"]
    shape = (2, WINDOWS, WINDOW, BATCH, LM["max_len"])
    xs, ys = engine.shard_batches(x.reshape(shape).astype(np.int64),
                                  ((x + 1) % LM["vocab_size"]).reshape(shape).astype(np.int64))
    state = engine.init_state(torch.Generator().manual_seed(0), None)
    for epoch in range(EPOCHS):
        print(json.dumps({"rank": rank, "epoch": epoch, "start": time.time()}), flush=True)
        state, stats = engine.run_epoch(state, xs, ys)
        print(json.dumps({"rank": rank, "epoch": epoch, "loss": stats["loss"].tolist(),
                          **engine.graph_stats}), flush=True)
    return 0


def main(argv) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wait", type=float, default=60.0)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--init", default=None)
    parser.add_argument("--logdir", default=None)
    args = parser.parse_args(argv)
    if args.rank is not None:
        try:
            return rank_main(args.rank, args.init)
        except Exception:  # noqa: BLE001 — the injected fault: end without NCCL's teardown
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_dead_peer: needs two CUDA cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distkeras_tpu_torch.ops import _build

    _build.build_all()
    with tempfile.TemporaryDirectory() as workdir:
        init = "file://" + os.path.join(workdir, f"rendezvous_{uuid.uuid4().hex}")
        logdir = args.logdir or workdir
        os.makedirs(logdir, exist_ok=True)
        logs = [open(os.path.join(logdir, f"dead_peer_rank_{r}.txt"), "w+", encoding="utf-8")
                for r in range(2)]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), "--init", init],
                                  cwd=ROOT, stdout=logs[r], stderr=subprocess.STDOUT,
                                  start_new_session=True)
                 for r in range(2)]
        t0, ended, hung = time.monotonic(), None, None
        try:
            procs[1].wait(timeout=150)
            ended = time.monotonic()
            try:
                procs[0].wait(timeout=args.wait)
                hung = False
            except subprocess.TimeoutExpired:
                hung = True
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
            time.sleep(3)
            for p in procs:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
    row = dict(phase="dead_peer", rank1_exit=procs[1].returncode,
               rank1_ran_s=None if ended is None else ended - t0,
               rank0_exit=procs[0].returncode,
               rank0_hung_past_rank1_s=args.wait if hung else None, rank0_hung=hung,
               rank1_error=[ln for ln in out[1].splitlines() if "Error" in ln][-1:],
               rank0_progress=[ln for ln in out[0].splitlines() if ln.startswith("{")],
               rank0_stack=[ln.strip() for ln in out[0].splitlines()
                            if ln.strip().startswith("File ")][:40],
               rank1_tail=out[1][-1500:] if ended is None else None)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
