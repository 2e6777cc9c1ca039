"""Window scheduling — the train half of the online loop, co-scheduled with
serving.

The port of :mod:`distkeras_tpu.online.scheduler`, host code copied.
:class:`WindowScheduler` polls a capture directory for windows
:class:`~distkeras_tpu_torch.online.capture.TrafficLog` has published, and
closes each one through the hardened train→serve wire: verify the window's
shard digests, retrain on it (``train_fn``), save the resulting training
state as a checkpoint step with a
:class:`~distkeras_tpu_torch.datapipe.DataState` sidecar tying the step back
to the capture stream position, and block until the verified manifest
publishes — at which point the serving tier's checkpoint watcher
(:meth:`ServingTier.watch_checkpoints` /
:func:`~distkeras_tpu_torch.serving.watch_and_swap`) rolls the fleet while
it keeps serving.  Chaos folds in at the ``epoch`` fault site, crossed
before ``train_fn`` and so before any device work (a seeded ``kill_epoch``
kills one retrain, the scheduler retries the window, and the retried
window launches the attention kernels as often as an unkilled one) and
the checkpoint corruption sites (a ``torn_ckpt`` step is rejected at swap
time; the next window's step swaps instead).

The port's checkpoints hold a ``TrainState``
(:mod:`distkeras_tpu_torch.checkpoint`), so ``train_fn`` returns one: the
state of the trainer's last fit, whose ``center_params`` the serving
side's loader restores with
:func:`~distkeras_tpu_torch.checkpoint.restore_center`.

:func:`plan_placement` is the capacity-aware placement decision the daemon's
``online_loop`` verb records: given the fleet's live leases, the trainer
lands on the highest-capacity member and serving replicas spread over the
remaining capacity round-robin (sharing the trainer's member only when the
fleet is that small).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from distkeras_tpu_torch import chaos as _chaos
from distkeras_tpu_torch.datapipe.state import DataState
from distkeras_tpu_torch.online.capture import (
    load_window_manifest,
    online_metrics,
    published_windows,
    verify_window,
    window_source,
)

__all__ = ["WindowScheduler", "plan_placement"]


def plan_placement(members: Dict[str, dict], replicas: int) -> dict:
    """Capacity-aware placement of one trainer job + ``replicas`` serving
    replicas over the fleet's live leases.

    ``members`` is the :meth:`FleetMembership.snapshot` ``members`` map
    (``{worker_id: {"workers": capacity, ...}}``).  The trainer takes the
    highest-capacity member (retraining is the throughput-bound job);
    replicas fill the *other* members round-robin weighted by capacity, and
    only overflow onto the trainer's member when the remaining capacity
    cannot hold them — so a one-member fleet still gets a complete
    placement instead of a refusal.  Returns ``{"trainer": worker_id|None,
    "replicas": {worker_id: count}, "capacity": total}``.
    """
    replicas = max(0, int(replicas))
    if not members:
        return {"trainer": None, "replicas": {}, "capacity": 0}
    ranked = sorted(members,
                    key=lambda wid: (-int(members[wid].get("workers", 1)), wid))
    trainer = ranked[0]
    capacity = {wid: max(1, int(members[wid].get("workers", 1)))
                for wid in ranked}
    # serving members: everyone but the trainer, unless that leaves nobody
    # or too little capacity for the replica count
    serving = ranked[1:] or ranked
    if sum(capacity[w] for w in serving) < replicas and trainer not in serving:
        serving = serving + [trainer]
    placed: Dict[str, int] = {}
    slots = [w for w in serving for _ in range(capacity[w])]
    for i in range(replicas):
        wid = slots[i % len(slots)]
        placed[wid] = placed.get(wid, 0) + 1
    return {"trainer": trainer, "replicas": placed,
            "capacity": sum(capacity.values())}


class WindowScheduler:
    """Close published capture windows into verified, hot-swappable
    checkpoints.

    ``train_fn(window, source) -> state`` does the retrain: ``window`` is
    the window index, ``source`` a
    :class:`~distkeras_tpu_torch.datapipe.MemmapSource` over its shards, and
    the returned ``TrainState`` is what
    :func:`distkeras_tpu_torch.checkpoint.save_checkpoint` publishes as step
    ``window + step_offset``.  Steps must be new — the
    scheduler never re-publishes a step that already committed (restart
    safety: it baselines on the capture directory's trained cursor, carried
    in the checkpoint directory's committed steps).

    Single-threaded: call :meth:`step_once` from your own loop, or
    :meth:`start` the built-in polling thread.
    """

    def __init__(self, capture_dir: str, train_fn: Callable,
                 checkpoint_dir: str, *, poll_interval: float = 0.25,
                 step_offset: int = 1, max_retries: int = 3,
                 registry=None, window_span_s: float = 30.0,
                 slo_objectives=None, clock=time.monotonic):
        self.capture_dir = capture_dir
        self.checkpoint_dir = checkpoint_dir
        self.train_fn = train_fn
        self.poll_interval = float(poll_interval)
        self.step_offset = int(step_offset)
        self.max_retries = int(max_retries)
        # window_span_s: expected wall-clock cadence of window publication;
        # the shipped SLO alerts once the untrained backlog ages past 2x it.
        self.window_span_s = float(window_span_s)
        self._slo_objectives = slo_objectives
        self._slo = None
        self._clock = clock
        self._metrics = online_metrics(registry)
        self._seen: Dict[int, float] = {}  # window -> first-seen monotonic
        self._last_publish: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.trained = self._baseline_trained()

    def _baseline_trained(self) -> int:
        """Highest window already closed into a committed checkpoint step
        (restart safety: never retrain or re-publish it)."""
        from distkeras_tpu_torch.checkpoint import committed_steps

        steps = committed_steps(self.checkpoint_dir)
        return (max(steps) - self.step_offset) if steps else -1

    # ----------------------------------------------------------- the loop

    def pending_windows(self) -> list:
        """Published-but-untrained window indices, oldest first."""
        published = published_windows(self.capture_dir)
        with self._lock:
            trained = self.trained
        return [w for w in published if w > trained]

    def _update_gauges(self, pending: list) -> None:
        now = self._clock()
        with self._lock:
            for w in pending:
                self._seen.setdefault(w, now)
            self._seen = {w: t for w, t in self._seen.items()
                          if w in set(pending)}
            lag = ((now - min(self._seen[w] for w in pending))
                   if pending else 0.0)
            last_publish = self._last_publish
        self._metrics["window_lag_seconds"].set(lag)
        if last_publish is not None:
            self._metrics["swap_age_seconds"].set(now - last_publish)

    def step_once(self) -> Optional[int]:
        """Train the oldest pending window end to end; returns its index,
        or ``None`` when nothing is pending.  A retrain that raises (chaos
        ``kill_epoch``, a transient trainer fault) is retried up to
        ``max_retries`` times before the error propagates."""
        from distkeras_tpu_torch.checkpoint import (
            save_checkpoint,
            save_data_state,
            wait_until_finished,
        )

        pending = self.pending_windows()
        self._update_gauges(pending)
        if not pending:
            return None
        window = pending[0]
        bad = verify_window(self.capture_dir, window)
        if bad is not None:
            raise RuntimeError(f"window {window} failed shard verification "
                               f"({bad}); refusing to train on torn data")
        manifest = load_window_manifest(self.capture_dir, window)
        source = window_source(self.capture_dir, window)
        t0 = self._clock()
        last_error: Optional[BaseException] = None
        for _ in range(self.max_retries + 1):
            try:
                if _chaos.enabled():
                    _chaos.fault("epoch")  # a killed retrain is retried
                state = self.train_fn(window, source)
                last_error = None
                break
            except Exception as e:  # noqa: BLE001 — counted, then retried
                last_error = e
                self._metrics["retrain_failures"].inc()
        if last_error is not None:
            raise last_error
        step = window + self.step_offset
        save_checkpoint(self.checkpoint_dir, state, step)
        save_data_state(
            self.checkpoint_dir,
            DataState(epoch=window,
                      block_cursor=int(manifest["last_seq"]) + 1),
            step)
        wait_until_finished()  # the verified manifest is the swap trigger
        with self._lock:
            self.trained = window
            self._last_publish = self._clock()
        self._metrics["windows_trained"].inc()
        self._metrics["retrain_seconds"].observe(self._clock() - t0)
        self._update_gauges(self.pending_windows())
        return window

    # ------------------------------------------------------------ control

    def start(self) -> None:
        """Run :meth:`step_once` from a background polling thread until
        :meth:`stop`.  A failed window (exhausted retries, torn shards) is
        left pending and re-attempted next poll rather than killing the
        loop."""
        from distkeras_tpu_torch.telemetry import slo as _slo

        objectives = self._slo_objectives
        if objectives is None:
            objectives = _slo.default_online_objectives(self.window_span_s)
        # None unless telemetry + DISTKERAS_ROLLUP are on — the flag-off
        # polling loop is untouched.
        engine = _slo.maybe_engine(objectives, source="online")
        with self._lock:
            if self._thread is not None:
                return
            if self._slo is None:
                self._slo = engine
            self._stop.clear()

            def _loop():
                while not self._stop.wait(self.poll_interval):
                    try:
                        self.step_once()
                        with self._lock:
                            slo_engine = self._slo
                        if slo_engine is not None:
                            slo_engine.evaluate()
                    except Exception:  # noqa: BLE001 — retried next poll
                        continue

            self._thread = threading.Thread(
                target=_loop, name="online-window-scheduler", daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout=timeout)

    def status(self) -> dict:
        """JSON-safe progress view (the daemon's ``online_status`` verb)."""
        published = published_windows(self.capture_dir)
        with self._lock:
            trained = self.trained
        return {
            "windows_published": len(published),
            "windows_trained": trained + 1,
            "pending": [w for w in published if w > trained],
        }
