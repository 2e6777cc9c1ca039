"""What every cell shares: finding its parts by name, the run's
environment, the card check, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix.  Its parts are files found by those names:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``driver``
key names ``drivers/<driver>.py``), ``workloads/<cell>.json`` (the limits of
the correctness check) and ``metrics/<metric>.py`` for each per-layer
metric.  A later cell, mix, driver or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

#: the checkout: ``BENCHMARK.json`` and the program sit here
ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
#: top-level module names that no process of the benchmark may hold: the
#: JAX package and JAX itself (compared whole: the port's name begins with
#: the JAX package's)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "distkeras_tpu")
#: build and kernel caches of the program, at fixed paths inside the checkout
CACHE_DIR = ROOT / ".portbench_cache"


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under ``name`` (metric files carry
    dots in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def resolve(manifest: dict, name: str) -> Cell:
    """The cell ``name`` of ``manifest`` with its configuration, traffic
    and limits loaded, and the metrics that apply to it."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(ROOT / configs[entry["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str):
    """The reader module of the per-layer metric ``name``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def per_layer_module(run: "Run", name: str):
    """The reader of the per-layer metric ``name``, loaded once a run."""
    if name not in run.readers:
        run.readers[name] = metric_reader(name)
    return run.readers[name]


def measure_per_layer(run: "Run") -> None:
    """In a ``--trace 1`` run, let each of the cell's per-layer metrics
    that measures something itself (a ``measure(run)`` in its file) do so.
    Drivers call this after the window has closed and the memory peak has
    been read, before the reference runs."""
    if not run.traced:
        return
    for entry in run.cell.per_layer:
        reader = per_layer_module(run, entry["name"])
        if hasattr(reader, "measure"):
            reader.measure(run)


def driver_module(kind: str):
    """``drivers/<kind>.py``, the driver of one kind of traffic."""
    return load_module(BENCH_DIR / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def set_cache_environment() -> None:
    """Point every build and kernel cache the program or its libraries may
    use at fixed directories inside the checkout, and keep ``transformers``
    from loading JAX, TensorFlow or Flax.  Called before torch is imported.
    (The port's own kernels build into ``distkeras_tpu_torch/_build/``,
    also inside the checkout.)"""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def forbidden_loaded() -> List[str]:
    """Top-level names of :data:`FORBIDDEN_MODULES` present in
    ``sys.modules``, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def require_cards(chips: int):
    """The card this run measures on, after checking that CUDA is there
    with at least ``chips`` cards; raises :class:`NoCard` otherwise.  A run
    never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark runs only on a card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards; torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def memory_peak(device) -> int:
    """The most device memory the process's tensors held (0 off a card)."""
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free_memory(device) -> None:
    """Collect what the program left and hand its cached blocks back."""
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them (or
    why it could not)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc})"


@dataclasses.dataclass
class Run:
    """One run of one cell: its arguments, what the driver measured, and
    what the per-layer readers read.  ``facts`` carries the driver's counts
    and shapes to the readers; ``trace`` the parsed device trace of a
    ``--trace 1`` run (:class:`portbench.tracing.TraceSummary`)."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    t0: float
    device: Any = None
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    trace: Any = None
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the per-layer metrics' reader modules, by name
    readers: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def check(self, name: str, value: float, limit: float) -> None:
        """Record one compared number beside its limit."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())


def number(value: float) -> float:
    """A metric's value as JSON can hold it (a float, all its digits)."""
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f"metric value {value} is not finite")
    return value


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> str:
    """The last line of standard output.  ``checks`` comes last, each
    compared number beside its limit."""
    out: Dict[str, Any] = {
        "correct": run.correct,
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = run.checks
    return json.dumps(out)


def print_checks(run: Run) -> None:
    """Each compared number beside its limit, as the last lines of
    standard error."""
    for name, c in run.checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
