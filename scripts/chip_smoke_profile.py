"""Where ``chip_smoke.py``'s wall time goes, phase by phase.

    python scripts/chip_smoke_profile.py [--interval 0.01] [--ranks]
        [--out chip_smoke_profile] [-- COMMAND ...]

Runs ``COMMAND`` (by default ``python chip_smoke.py``; a phase's own
script, ``python scripts/chip_seq_phase.py``, works too) with a stack
sampler in its Python process and the gloo lane's, and with ``--ranks``
in every rank they spawn as well (through a ``sitecustomize`` put first on ``PYTHONPATH``):
a thread that reads the main thread's stack every ``--interval`` seconds
and charges the time since its last read to that stack.  Each process
writes its samples when it exits; then the report charges the main
process's and the gloo lane's seconds to the phase (the outermost
function of ``chip_smoke.py`` below ``main``) and, within a phase, to the
deepest line of ``chip_smoke.py`` and to the innermost function of any
file, and does the same for each kind of spawned rank (by its flag).
Writes ``report.txt`` and the raw samples under ``--out`` and prints the
report; the command's own output goes to ``smoke.txt`` there.  Exits with
the command's code.  The sampler holds the GIL for a stack walk each
interval: about 1 % of a process's time.
"""

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

SITECUSTOMIZE = r'''
import atexit, json, os, sys, threading, time

_dir = os.environ.get("SMOKE_PROFILE_DIR")
if _dir and (os.environ.get("SMOKE_PROFILE_RANKS") == "1"
             or not any(a.endswith("-rank") for a in sys.argv)):
    _interval = float(os.environ.get("SMOKE_PROFILE_INTERVAL", "0.01"))
    _main = threading.main_thread().ident
    _counts = {}
    _stop = threading.Event()
    _t_start = time.perf_counter()

    def _stack(frame):
        out = []
        while frame is not None and len(out) < 60:
            code = frame.f_code
            out.append(f"{code.co_filename}:{code.co_name}:{frame.f_lineno}")
            frame = frame.f_back
        return "|".join(reversed(out))

    def _sample():
        last = time.perf_counter()
        while not _stop.wait(_interval):
            now = time.perf_counter()
            frame = sys._current_frames().get(_main)
            if frame is not None:
                key = _stack(frame)
                _counts[key] = _counts.get(key, 0.0) + (now - last)
            last = now

    _thread = threading.Thread(target=_sample, name="smoke-profile", daemon=True)
    _thread.start()

    @atexit.register
    def _dump():
        _stop.set()
        _thread.join(timeout=5)  # ended before the interpreter finalizes
        path = os.path.join(_dir, f"samples_{os.getpid()}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(dict(argv=sys.argv, wall=time.perf_counter() - _t_start,
                           stacks=_counts), fh)
'''


def _frames(stack: str):
    return [f.rsplit(":", 2) for f in stack.split("|")]


def _phase_of(frames, script: str):
    """The outermost function of chip_smoke.py other than its ``main``,
    ``timed`` and module body, or where the process stood."""
    own = [name for path, name, _ in frames if path.endswith(script)]
    for name in own:
        if name not in ("main", "timed", "<lambda>", "<module>", "gloo_lane_main", "gloo_lane"):
            return name
    return f"({own[-1]})" if own else "(outside chip_smoke.py)"


def _report(out_dir: str, top: int) -> str:
    lines = []
    by_kind = collections.defaultdict(list)
    for path in sorted(glob.glob(os.path.join(out_dir, "samples_*.json"))):
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        flag = next((a for a in data["argv"] if a.endswith("-rank") or a == "--gloo-lane"),
                    None)
        by_kind[flag or "main process"].append(data)
    for kind, runs in sorted(by_kind.items(), key=lambda kv: kv[0] != "main process"):
        phases = collections.Counter()
        deepest = collections.defaultdict(collections.Counter)
        inner = collections.defaultdict(collections.Counter)
        for data in runs:
            for stack, seconds in data["stacks"].items():
                frames = _frames(stack)
                phase = kind if kind.endswith("-rank") else _phase_of(frames, "chip_smoke.py")
                phases[phase] += seconds
                own = [f for f in frames if f[0].endswith("chip_smoke.py")]
                if own:
                    deepest[phase][f"{own[-1][1]}:{own[-1][2]}"] += seconds
                path, name, line = frames[-1]
                inner[phase][f"{os.path.basename(path)}:{name}:{line}"] += seconds
        walls = [d["wall"] for d in runs]
        lines.append(f"== {kind}: {len(runs)} process(es), wall {sum(walls):.1f} s "
                     f"summed (largest {max(walls):.1f} s)")
        for phase, seconds in phases.most_common():
            lines.append(f"  {phase}: {seconds:.1f} s")
            for where, s in deepest[phase].most_common(top):
                if s >= 0.5:
                    lines.append(f"      chip_smoke {where}: {s:.1f} s")
            for where, s in inner[phase].most_common(top):
                if s >= 0.5:
                    lines.append(f"      innermost {where}: {s:.1f} s")
    return "\n".join(lines) + "\n"


def main(argv) -> int:
    if "--" in argv:
        cut = argv.index("--")
        argv, command = argv[:cut], argv[cut + 1:]
    else:
        command = [sys.executable, str(ROOT / "chip_smoke.py")]
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--interval", type=float, default=0.01, help="seconds between reads")
    parser.add_argument("--out", default=str(ROOT / "chip_smoke_profile"),
                        help="directory for the samples and the report")
    parser.add_argument("--top", type=int, default=8, help="lines shown for each phase")
    parser.add_argument("--ranks", action="store_true",
                        help="sample the spawned ranks (--X-rank) too")
    args = parser.parse_args(argv)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    for old in glob.glob(os.path.join(out_dir, "samples_*.json")):
        os.remove(old)
    with tempfile.TemporaryDirectory() as site:
        with open(os.path.join(site, "sitecustomize.py"), "w", encoding="utf-8") as fh:
            fh.write(SITECUSTOMIZE)
        env = dict(os.environ, SMOKE_PROFILE_DIR=out_dir,
                   SMOKE_PROFILE_INTERVAL=str(args.interval),
                   SMOKE_PROFILE_RANKS="1" if args.ranks else "0",
                   PYTHONPATH=os.pathsep.join(
                       [site] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        with open(os.path.join(out_dir, "smoke.txt"), "w", encoding="utf-8") as log:
            rc = subprocess.run(command, cwd=ROOT, env=env, stdout=log, check=False).returncode
        wall = time.perf_counter() - t0
    report = f"{' '.join(command)}: exit {rc}, wall {wall:.1f} s\n" + _report(out_dir, args.top)
    with open(os.path.join(out_dir, "report.txt"), "w", encoding="utf-8") as fh:
        fh.write(report)
    print(report, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
