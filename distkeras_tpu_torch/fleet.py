"""Elastic fleet membership and preemption: the port of
:mod:`distkeras_tpu.fleet`, copied (framework-neutral host code).

* :class:`FleetMembership` — the daemon-side table behind the ``register``
  / ``heartbeat`` / ``deregister`` / ``membership`` verbs of
  :class:`~distkeras_tpu_torch.job_deployment.PunchcardServer`.  Liveness
  is a lease: a worker that misses ``lease x miss_tolerance`` seconds of
  heartbeats is evicted.  Every join, leave or eviction bumps a
  monotonically increasing **membership epoch** — the single integer
  trainers poll to learn "the fleet changed".  The clock is injectable.
* :class:`FleetWorker` — the worker-side client: registers, heartbeats
  from a daemon thread, re-registers transparently after an eviction.
* :class:`ElasticMembership` — the trainer-side poller a trainer takes as
  ``elastic=``: ``poll()`` returns the new desired worker count when the
  membership epoch moved, ``None`` otherwise (including on transient
  daemon unreachability — elasticity is best-effort and must never kill a
  healthy run).

Preemption: :func:`install_preemption_handler` turns SIGTERM into a flag
trainers check at epoch boundaries (:func:`preemption_requested`), so a
preempted worker drains to a boundary checkpoint and exits via
:class:`Preempted` instead of dying mid-step; ``train_with_recovery``
never retries it.
"""

from __future__ import annotations

import signal
import threading
import time
import uuid
from typing import Callable, Dict, Optional

__all__ = [
    "ElasticMembership",
    "FleetMembership",
    "FleetWorker",
    "Preempted",
    "install_preemption_handler",
    "preemption_requested",
    "reset_preemption",
]


# -- preemption (SIGTERM -> graceful boundary drain) -------------------------

_PREEMPTED = threading.Event()
_HANDLER_INSTALLED = False


class Preempted(RuntimeError):
    """Raised by trainers at the epoch boundary after SIGTERM: the boundary
    checkpoint is on disk, the process should exit and let a replacement
    resume from it."""


def _on_sigterm(signum, frame):  # pragma: no cover — exercised via raise path
    del signum, frame
    _PREEMPTED.set()


def install_preemption_handler() -> bool:
    """Install the SIGTERM→flag handler (idempotent).  Returns ``False``
    when it cannot be installed (non-main thread — signal handlers are a
    main-thread-only API), in which case preemption falls back to the
    default SIGTERM kill and recovery runs through the checkpoint path."""
    global _HANDLER_INSTALLED
    if _HANDLER_INSTALLED:
        return True
    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        return False
    _HANDLER_INSTALLED = True
    return True


def preemption_requested() -> bool:
    return _PREEMPTED.is_set()


def reset_preemption() -> None:
    """Clear the preemption flag (tests, or a worker that drained and is
    deliberately continuing)."""
    _PREEMPTED.clear()


# -- daemon-side membership table --------------------------------------------

class FleetMembership:
    """Lease-based membership table.  NOT self-locking: the daemon calls
    every method under its own condition variable (one lock domain for
    queue + jobs + fleet keeps the lock-order graph a single node).  The
    clock is injectable so lease expiry is testable without sleeping."""

    def __init__(self, lease: float = 10.0, miss_tolerance: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        if lease <= 0:
            raise ValueError(f"lease must be > 0, got {lease}")
        if miss_tolerance < 1:
            raise ValueError(
                f"miss_tolerance must be >= 1, got {miss_tolerance}")
        self.lease = float(lease)
        self.miss_tolerance = int(miss_tolerance)
        self._clock = clock
        self.members: Dict[str, dict] = {}
        #: monotonically increasing; bumps on every join, leave, or eviction
        self.epoch = 0
        self.evictions = 0

    def _deadline(self) -> float:
        return self._clock() + self.lease * self.miss_tolerance

    def register(self, worker_id: Optional[str] = None, workers: int = 1,
                 host: Optional[str] = None,
                 meta: Optional[dict] = None) -> str:
        """Join (or re-join) the fleet; returns the worker id.  A re-register
        of a live member only refreshes its lease — the epoch moves only
        when the member set actually changes.  ``meta`` is an opaque
        JSON-safe dict carried through to :meth:`snapshot` (the serving
        tier tags replicas with their role/index here)."""
        wid = worker_id or uuid.uuid4().hex
        fresh = wid not in self.members
        self.members[wid] = {
            "workers": int(workers),
            "host": host,
            "meta": dict(meta) if meta else {},
            "deadline": self._deadline(),
        }
        if fresh:
            self.epoch += 1
        return wid

    def heartbeat(self, worker_id: str) -> bool:
        """Refresh the lease; ``False`` for an unknown (evicted or never
        registered) worker — the caller must re-register."""
        member = self.members.get(worker_id)
        if member is None:
            return False
        member["deadline"] = self._deadline()
        return True

    def deregister(self, worker_id: str) -> bool:
        if self.members.pop(worker_id, None) is None:
            return False
        self.epoch += 1
        return True

    def sweep(self) -> list:
        """Evict every member whose lease expired; returns the evicted ids.
        One epoch bump per sweep regardless of how many fell — pollers care
        that the set changed, not how many times."""
        now = self._clock()
        evicted = [wid for wid, m in self.members.items()
                   if m["deadline"] < now]
        for wid in evicted:
            del self.members[wid]
        if evicted:
            self.epoch += 1
            self.evictions += len(evicted)
        return evicted

    def workers_total(self) -> int:
        return sum(m["workers"] for m in self.members.values())

    def snapshot(self) -> dict:
        """JSON-safe view for the ``membership`` verb."""
        return {
            "epoch": self.epoch,
            "workers_total": self.workers_total(),
            "evictions": self.evictions,
            "members": {
                wid: {"workers": m["workers"], "host": m["host"],
                      **({"meta": m["meta"]} if m.get("meta") else {})}
                for wid, m in self.members.items()
            },
        }


# -- worker-side client ------------------------------------------------------

class FleetWorker:
    """Register with a Punchcard daemon and keep the lease alive from a
    background thread; transparently re-registers after an eviction (a
    stalled-then-recovered worker rejoins instead of staying a ghost)."""

    def __init__(self, host: str, port: int, secret: str = "",
                 workers: int = 1, worker_id: Optional[str] = None,
                 address: Optional[str] = None,
                 heartbeat_interval: Optional[float] = None):
        from distkeras_tpu_torch.job_deployment import Job

        self._job = Job(host, port, secret=secret)
        self.worker_id = worker_id or uuid.uuid4().hex
        self.workers = int(workers)
        self.address = address
        self.lease: Optional[float] = None
        self.membership_epoch: Optional[int] = None
        self.rejoins = 0
        # register() runs on the caller's thread *and* on the heartbeat
        # thread (re-register after eviction); this lock keeps the
        # lease / epoch / rejoins triple coherent across both.
        self._state_lock = threading.Lock()
        self._interval = heartbeat_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self) -> int:
        reply = self._job._rpc({
            "action": "register", "worker_id": self.worker_id,
            "workers": self.workers, "host": self.address,
        })
        if reply.get("status") != "ok":
            raise RuntimeError(f"register rejected: {reply}")
        with self._state_lock:
            self.lease = float(reply["lease"])
            self.membership_epoch = int(reply["epoch"])
            return self.membership_epoch

    def heartbeat(self) -> int:
        """One heartbeat round-trip; re-registers on eviction.  Returns the
        daemon's current membership epoch."""
        reply = self._job._rpc(
            {"action": "heartbeat", "worker_id": self.worker_id})
        if reply.get("status") == "unknown":
            # evicted (lease missed) — rejoin under the same id
            with self._state_lock:
                self.rejoins += 1
            return self.register()
        if reply.get("status") != "ok":
            raise RuntimeError(f"heartbeat rejected: {reply}")
        with self._state_lock:
            self.membership_epoch = int(reply["epoch"])
            return self.membership_epoch

    def deregister(self) -> None:
        self._job._rpc(
            {"action": "deregister", "worker_id": self.worker_id})

    def start(self) -> None:
        """Register now and heartbeat from a daemon thread at a third of the
        lease (so ``miss_tolerance`` misses take several lost beats)."""
        self.register()
        interval = self._interval or max(self.lease / 3.0, 0.02)

        def _beat():
            while not self._stop.wait(interval):
                try:
                    self.heartbeat()
                except (OSError, ConnectionError, ValueError, RuntimeError):
                    # transient control-plane failure: keep beating; the
                    # lease's miss tolerance absorbs it, and a real daemon
                    # outage evicts us exactly as designed
                    continue

        self._thread = threading.Thread(target=_beat, daemon=True)
        self._thread.start()

    def stop(self, deregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if deregister:
            try:
                self.deregister()
            except (OSError, ConnectionError, ValueError):
                pass  # daemon already gone; the lease will expire us


# -- trainer-side poller -----------------------------------------------------

class ElasticMembership:
    """Trainer-facing epoch-boundary poller over the ``membership`` verb.

    ``poll()`` contacts the daemon and returns the new desired worker count
    when the membership epoch changed since the last poll; ``None`` when
    the fleet is unchanged, on the first (baseline) poll, or when the
    daemon is transiently unreachable.  The count is the fleet's summed
    per-member ``workers``, clamped to ``[min_workers, max_workers]``.
    """

    def __init__(self, host: str, port: int, secret: str = "",
                 min_workers: int = 1, max_workers: Optional[int] = None):
        from distkeras_tpu_torch.job_deployment import Job

        self._job = Job(host, port, secret=secret)
        self.min_workers = int(min_workers)
        self.max_workers = max_workers
        self.last_epoch: Optional[int] = None

    def poll(self) -> Optional[int]:
        try:
            reply = self._job._rpc({"action": "membership"})
        except (OSError, ConnectionError, ValueError):
            return None
        if reply.get("status") != "ok":
            return None
        epoch = int(reply["epoch"])
        if self.last_epoch == epoch:
            return None
        first = self.last_epoch is None
        self.last_epoch = epoch
        if first:
            return None  # baseline read, not a change
        n = max(self.min_workers, int(reply.get("workers_total") or 0))
        if self.max_workers is not None:
            n = min(n, int(self.max_workers))
        return n
