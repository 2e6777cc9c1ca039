"""Preemption support: SIGTERM becomes a boundary checkpoint and an exit.

The port of :mod:`distkeras_tpu.fleet`'s preemption half (copied):
:func:`install_preemption_handler` turns SIGTERM into a flag trainers check
at epoch boundaries (:func:`preemption_requested`), so a preempted worker
drains to a boundary checkpoint and exits via :class:`Preempted` instead of
dying mid-step; ``train_with_recovery`` never retries it.  Elastic
membership (``FleetMembership``, ``FleetWorker``, ``ElasticMembership``)
comes with ROADMAP Queue A item 18.
"""

from __future__ import annotations

import signal
import threading

__all__ = [
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
