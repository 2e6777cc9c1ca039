"""Training-dynamics observability: on-device health stats + watchdog.

The port of :mod:`distkeras_tpu.telemetry.dynamics`.  The async trainers
(DOWNPOUR/AEASGD/EAMSGD/ADAG/DynSGD) live or die by quantities the host
normally cannot see without breaking the async pipeline: gradient
magnitude, worker<->center drift, update size, and effective staleness.
This module provides

* ``DynamicsConfig`` — env-driven switch (``DISTKERAS_DYNAMICS``) plus
  watchdog knobs (``DISTKERAS_DYNAMICS_WATCHDOG``,
  ``DISTKERAS_DYNAMICS_FACTOR``).  Like ``runtime.enabled()`` the config
  is resolved once and cached; an engine reads it once, when it is built.
* tensor helpers (``tree_sq_norm`` / ``tree_sq_dist`` /
  ``tree_nonfinite_count``) used by ``parallel/engine.py`` to compute the
  stats on the device, in the window (inside a captured window too), so
  they reach the host with the epoch's loss, at the one read-back an epoch
  already makes — no new host sync.  ``keep=1`` keeps the leading (worker)
  dim: one value a worker; ``weights`` (one float a leaf) scales each
  leaf's share (the tensor-parallel engine's way to count a leaf that
  every model rank holds whole only once).
* host-side ``summarize``/``record`` that turn the per-epoch dynamics
  arrays into telemetry gauges and a JSONL series, and
  ``DivergenceWatchdog`` with ``warn | halt | rollback`` policies (copied).

Import cost is stdlib-only; torch is imported inside the tensor helpers.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Optional

from distkeras_tpu_torch.telemetry import runtime as _runtime
from distkeras_tpu_torch.telemetry import metrics as _metrics_mod
from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder as _flight_recorder

_FALSEY = ("", "0", "false", "no")

#: Watchdog policies, in escalation order.
WATCHDOG_POLICIES = ("off", "warn", "halt", "rollback")


class TrainingDiverged(RuntimeError):
    """Raised by the watchdog under the ``halt`` policy (or when a
    ``rollback`` cannot proceed) to stop a diverging run."""


@dataclass(frozen=True)
class DynamicsConfig:
    """Resolved training-dynamics settings.

    ``enabled`` gates the in-graph stats; the remaining fields configure
    the host-side :class:`DivergenceWatchdog` built from them.
    """

    enabled: bool = False
    watchdog: str = "warn"
    divergence_factor: float = 10.0
    history: int = 32
    min_history: int = 3
    max_rollbacks: int = 2

    def __post_init__(self) -> None:
        if self.watchdog not in WATCHDOG_POLICIES:
            raise ValueError(
                f"watchdog policy must be one of {WATCHDOG_POLICIES}, "
                f"got {self.watchdog!r}")
        if self.divergence_factor <= 1.0:
            raise ValueError("divergence_factor must be > 1")

    @classmethod
    def from_env(cls) -> "DynamicsConfig":
        enabled = os.environ.get("DISTKERAS_DYNAMICS", "").lower() not in _FALSEY
        policy = os.environ.get("DISTKERAS_DYNAMICS_WATCHDOG", "warn").lower()
        factor = float(os.environ.get("DISTKERAS_DYNAMICS_FACTOR", "10.0"))
        return cls(enabled=enabled, watchdog=policy, divergence_factor=factor)


_CONFIG: Optional[DynamicsConfig] = None
_CONFIG_LOCK = threading.Lock()


def config() -> DynamicsConfig:
    """The cached config; resolved from the environment on first use."""
    global _CONFIG
    if _CONFIG is None:
        with _CONFIG_LOCK:
            if _CONFIG is None:
                _CONFIG = DynamicsConfig.from_env()
    return _CONFIG


def configure(cfg: Optional[DynamicsConfig] = None, **overrides: Any) -> DynamicsConfig:
    """Override the cached config (tests / programmatic use).

    ``configure()`` with no arguments re-reads the environment.  Keyword
    overrides are applied on top of ``cfg`` (or the env config).
    """
    global _CONFIG
    with _CONFIG_LOCK:
        base = cfg if cfg is not None else DynamicsConfig.from_env()
        if overrides:
            base = DynamicsConfig(**{**base.__dict__, **overrides})
        _CONFIG = base
    return _CONFIG


def enabled() -> bool:
    return config().enabled


# ---------------------------------------------------------------------------
# Tensor helpers.  Called in the engines' windows; each returns an f32
# tensor on the leaves' device (a scalar, or ``[v]`` with ``keep=1``).
# ---------------------------------------------------------------------------


def _pairs(trees, weights):
    """Float leaves of the trees, paired by key, with their weights (1.0
    without)."""
    from distkeras_tpu_torch.utils.pytree import tree_map

    out = []
    if weights is None:
        tree_map(lambda *xs: out.append((xs, 1.0)), *trees)
    else:
        tree_map(lambda w, *xs: out.append((xs, w)), weights, *trees)
    return [(xs, w) for xs, w in out if xs[0].is_floating_point()]


def _total(parts, keep: int, tree):
    """Sum of per-leaf partial sums (each reduced over every dim past
    ``keep``), as f32 on the tree's device."""
    import torch

    from distkeras_tpu_torch.utils.pytree import tree_leaves

    like = next(iter(tree_leaves(tree)), None)
    zero = torch.zeros(tuple(like.shape[:keep]) if like is not None else (),
                       dtype=torch.float32, device=None if like is None else like.device)
    return sum(parts, zero)


def _reduce(x, keep: int):
    return x.reshape(tuple(x.shape[:keep]) + (-1,)).sum(-1) if keep else x.sum()


def tree_sq_norm(tree: Any, keep: int = 0, weights: Any = None):
    """Sum of squares over every floating leaf, as f32."""
    parts = (w * _reduce(x.float().square(), keep) for (x,), w in _pairs((tree,), weights))
    return _total(parts, keep, tree)


def tree_sq_dist(a: Any, b: Any, keep: int = 0, weights: Any = None):
    """Squared L2 distance between two same-structure trees (float leaves);
    ``b`` may lack ``a``'s leading ``keep`` dims (the center against the
    stacked workers)."""
    def one(x, y):
        return _reduce((x.float() - y.float()).square(), keep)

    parts = (w * one(x, y) for (x, y), w in _pairs((a, b), weights))
    return _total(parts, keep, a)


def tree_nonfinite_count(tree: Any, keep: int = 0, weights: Any = None):
    """Number of non-finite elements across floating leaves (f32, so the
    engines sum it alongside the other dynamics leaves)."""
    import torch

    def one(x):
        return _reduce((~torch.isfinite(x)).to(torch.float32), keep)

    parts = (w * one(x) for (x,), w in _pairs((tree,), weights))
    return _total(parts, keep, tree)


# ---------------------------------------------------------------------------
# Host side: per-epoch summaries, gauges, and the JSONL series.
# ---------------------------------------------------------------------------

#: Keys of per-window global leaves ([n_windows] arrays) in the stats dict.
GLOBAL_KEYS = ("grad_norm", "update_norm", "nonfinite_grads", "nonfinite_params")


def summarize(dyn: Dict[str, Any], loss: Any = None) -> Dict[str, float]:
    """Collapse one epoch's dynamics arrays to scalar gauges.

    1-D leaves (per-window globals) yield ``<k>`` (last window) and
    ``<k>_max``; 2-D leaves (per-window x per-worker) additionally yield
    ``<k>_mean`` over workers at the last window.  ``loss`` (if given)
    contributes ``loss_nonfinite`` — the count of non-finite loss values,
    which catches divergence even when the dynamics leaves saturate.
    """
    import numpy as np

    out: Dict[str, float] = {}
    for k in sorted(dyn):
        v = np.asarray(dyn[k], np.float64)
        if v.size == 0:
            continue
        with np.errstate(invalid="ignore"):
            if v.ndim >= 2:
                out[f"{k}_max"] = float(np.max(v))
                out[f"{k}_mean"] = float(np.mean(v[-1]))
            else:
                out[k] = float(v[-1])
                out[f"{k}_max"] = float(np.max(v))
    if loss is not None:
        larr = np.asarray(loss, np.float64)
        out["loss_nonfinite"] = float(np.size(larr) - np.sum(np.isfinite(larr)))
    return out


# Most recent recorded epoch summary — the /vars scrape and blackbox dumps
# read it so a crash report always carries the last known training health.
_LAST_SUMMARY: Optional[Dict[str, Any]] = None


def last_summary() -> Optional[Dict[str, Any]]:
    """``{"epoch", "summary", "unix"}`` of the latest :func:`record` call,
    or ``None`` before the first one (non-finite values stringified)."""
    return _LAST_SUMMARY


def record(epoch: int, dyn: Dict[str, Any], summary: Dict[str, float],
           directory: Optional[str] = None) -> None:
    """Publish one epoch of dynamics: gauges into the process registry and
    one JSON line (full per-window/per-worker series) into the metrics
    JSONL.  No-op when telemetry is disabled."""
    if not _runtime.enabled():
        return
    global _LAST_SUMMARY
    _LAST_SUMMARY = {
        "epoch": int(epoch),
        "summary": {k: (v if math.isfinite(v) else repr(v))
                    for k, v in sorted(summary.items())},
        "unix": time.time(),
    }
    record_gauges(summary)
    append_series(epoch, dyn, summary, directory=directory)


def record_gauges(summary: Dict[str, float], prefix: str = "dynamics_") -> None:
    """Set ``dynamics_<k>`` gauges for each summary scalar."""
    if not _runtime.enabled():
        return
    for k, v in summary.items():
        if math.isfinite(v):
            _metrics_mod.metrics.gauge(
                prefix + k, help="training-dynamics health stat").set(v)
        else:
            # a NaN gauge would poison max/mean fleet merges; surface the
            # event as a counter instead
            _metrics_mod.metrics.counter(
                prefix + "nonfinite_summaries_total",
                help="dynamics summary values that were non-finite").inc()


def append_series(epoch: int, dyn: Dict[str, Any], summary: Dict[str, float],
                  directory: Optional[str] = None) -> None:
    """Append the epoch's full dynamics series to ``metrics_<pid>.jsonl``."""
    if not _runtime.enabled():
        return
    import numpy as np

    directory = directory or _runtime.out_dir()
    os.makedirs(directory, exist_ok=True)
    pid = os.getpid()
    path = os.path.join(directory, f"metrics_{pid}.jsonl")

    def _tolist(v: Any):
        arr = np.asarray(v, np.float64)
        # JSON has no NaN/Inf literal; stringify non-finite entries
        flat = [x if math.isfinite(x) else repr(x) for x in arr.reshape(-1).tolist()]
        return {"shape": list(arr.shape), "values": flat}

    line = {
        "type": "dynamics",
        "pid": pid,
        "epoch": int(epoch),
        "series": {k: _tolist(v) for k, v in sorted(dyn.items())},
        "summary": {k: (v if math.isfinite(v) else repr(v))
                    for k, v in sorted(summary.items())},
    }
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(line) + "\n")


# ---------------------------------------------------------------------------
# Watchdog.
# ---------------------------------------------------------------------------


class DivergenceWatchdog:
    """Epoch-granularity health check over dynamics summaries.

    Trips on (a) any non-finite gradient/parameter/loss value, or (b) the
    per-epoch max divergence exceeding ``divergence_factor`` times the
    running median of recent healthy epochs.  Policies:

    * ``warn`` — emit a ``RuntimeWarning`` and keep training.
    * ``halt`` — raise :class:`TrainingDiverged`.
    * ``rollback`` — request a checkpoint restore from the trainer
      (``pending_rollback`` holds the reason); after ``max_rollbacks``
      restores the policy escalates to ``halt``.

    The check runs on host numpy arrays *after* the epoch's stats have been
    fetched — never inside the step loop.
    """

    def __init__(self, policy: str = "warn", divergence_factor: float = 10.0,
                 history: int = 32, min_history: int = 3,
                 max_rollbacks: int = 2) -> None:
        if policy not in WATCHDOG_POLICIES or policy == "off":
            raise ValueError(f"bad watchdog policy {policy!r}")
        self.policy = policy
        self.divergence_factor = float(divergence_factor)
        self.min_history = int(min_history)
        self.max_rollbacks = int(max_rollbacks)
        self._history: deque = deque(maxlen=int(history))
        self._rollbacks = 0
        self._pending: Optional[str] = None
        self.trips = 0

    @classmethod
    def from_config(cls, cfg: Optional[DynamicsConfig] = None
                    ) -> Optional["DivergenceWatchdog"]:
        cfg = cfg if cfg is not None else config()
        if not cfg.enabled or cfg.watchdog == "off":
            return None
        return cls(policy=cfg.watchdog,
                   divergence_factor=cfg.divergence_factor,
                   history=cfg.history, min_history=cfg.min_history,
                   max_rollbacks=cfg.max_rollbacks)

    @property
    def pending_rollback(self) -> Optional[str]:
        return self._pending

    @property
    def rollbacks(self) -> int:
        return self._rollbacks

    def rolled_back(self) -> None:
        """Trainer callback: the requested restore happened."""
        self._pending = None
        self._rollbacks += 1
        self._history.clear()

    def _diagnose(self, epoch: int, summary: Dict[str, float]) -> Optional[str]:
        nonfinite = (summary.get("nonfinite_grads_max", 0.0)
                     + summary.get("nonfinite_params_max", 0.0)
                     + summary.get("loss_nonfinite", 0.0))
        if nonfinite > 0:
            return (f"epoch {epoch}: {nonfinite:g} non-finite "
                    "gradient/parameter/loss values")
        div = summary.get("divergence_max")
        if div is None:
            return None
        if not math.isfinite(div):
            return f"epoch {epoch}: worker<->center divergence is {div!r}"
        if len(self._history) >= self.min_history:
            hist = sorted(self._history)
            median = hist[len(hist) // 2]
            if median > 0.0 and div > self.divergence_factor * median:
                return (f"epoch {epoch}: divergence {div:.3g} exceeds "
                        f"{self.divergence_factor:g}x running median "
                        f"{median:.3g}")
        return None

    def observe(self, epoch: int, summary: Dict[str, float]) -> Optional[str]:
        """Inspect one epoch summary.  Returns the action taken
        (``"warn"`` / ``"rollback"``) or ``None`` when healthy.  Raises
        :class:`TrainingDiverged` under the ``halt`` policy."""
        reason = self._diagnose(epoch, summary)
        if reason is None:
            div = summary.get("divergence_max")
            if div is not None and math.isfinite(div):
                self._history.append(div)
            self._note(epoch, "ok", None)
            return None
        self.trips += 1
        if _runtime.enabled():
            _metrics_mod.metrics.counter(
                "dynamics_watchdog_trips_total",
                help="divergence watchdog activations").inc()
        if self.policy == "warn":
            self._note(epoch, "warn", reason)
            warnings.warn(f"divergence watchdog: {reason}", RuntimeWarning,
                          stacklevel=2)
            return "warn"
        if self.policy == "rollback" and self._rollbacks < self.max_rollbacks:
            self._pending = reason
            self._note(epoch, "rollback", reason)
            return "rollback"
        suffix = ("" if self.policy == "halt"
                  else f" (rollback budget of {self.max_rollbacks} exhausted)")
        self._note(epoch, "halt", reason + suffix)
        raise TrainingDiverged(reason + suffix)

    def _note(self, epoch: int, action: str, reason: Optional[str]) -> None:
        # Feed the flight-recorder ring so a blackbox dump shows the
        # watchdog's view of the final epochs, not just the raised error.
        if not _runtime.enabled():
            return
        _flight_recorder.record_watchdog({
            "epoch": int(epoch),
            "action": action,
            "reason": reason,
            "policy": self.policy,
            "trips": self.trips,
            "rollbacks": self._rollbacks,
        })
