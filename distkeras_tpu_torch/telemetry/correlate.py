"""Fleet-wide run correlation: one ``run_id`` across trainer, daemon, jobs.

The port of :mod:`distkeras_tpu.telemetry.flightdeck.correlate` (copied):
the checkpoint manifest's ``run_id`` comes from here.

A fleet run involves several processes — a trainer, a ``PunchcardServer``
daemon, N spawned jobs — each writing its own trace and metrics files.
Without a shared key those artifacts cannot be joined back into one
timeline.  The ``run_id`` is that key: a short opaque token minted once per
fleet (by whichever entry point runs first — ``Trainer.fit``,
``PunchcardServer.start``, or an explicit :func:`run_id` call) and handed to
child processes through the ``DISTKERAS_RUN_ID`` environment variable.  The
correlated tracer stamps it into every span's ``args`` and the live
``/metrics`` scrape carries it as a Prometheus label, so
``tools.dktrace merge`` can verify that the traces it is stitching together
actually belong to the same run.

Resolution order: an explicit :func:`set_run_id`, then ``DISTKERAS_RUN_ID``
(the inherited fleet id), then — only when :func:`run_id` is called — a
freshly minted token.  :func:`current` never mints, so processes that never
start a run (imports, unit tests) stay unstamped.
"""

from __future__ import annotations

import os
import threading
import uuid
from typing import Optional

__all__ = ["current", "run_id", "set_run_id"]

_LOCK = threading.Lock()

# None = not yet resolved; once _RESOLVED is True, _RUN_ID holds the answer
# (possibly still None when the env carries no id and nothing minted one).
_RUN_ID: Optional[str] = None
_RESOLVED = False


def current() -> Optional[str]:
    """The run id this process is correlated under, or ``None``.

    Never mints: the hot stamping path (one call per recorded span) must not
    invent ids for processes that never started a run.  Cached after the
    first environment read.
    """
    global _RUN_ID, _RESOLVED
    if not _RESOLVED:
        with _LOCK:
            if not _RESOLVED:
                _RUN_ID = os.environ.get("DISTKERAS_RUN_ID") or None
                _RESOLVED = True
    return _RUN_ID


def run_id() -> str:
    """The run id, minting a fresh one if neither env nor a prior call set it.

    Entry points (``Trainer.fit``, ``PunchcardServer.start``, blackbox dumps)
    call this; everything downstream reads :func:`current`.
    """
    global _RUN_ID, _RESOLVED
    rid = current()
    if rid is None:
        with _LOCK:
            if _RUN_ID is None:
                _RUN_ID = uuid.uuid4().hex[:12]
                _RESOLVED = True
            rid = _RUN_ID
    return rid


def set_run_id(rid: Optional[str]) -> None:
    """Force the run id (tests, explicit fleet wiring) or reset to env-driven
    (``None``, re-read lazily on the next :func:`current` call)."""
    global _RUN_ID, _RESOLVED
    with _LOCK:
        _RUN_ID = rid
        _RESOLVED = rid is not None
