"""Sanitizer on/off/strict switch and violation routing: the port of
:mod:`distkeras_tpu.sanitizer.runtime` (host code, copied).

The sanitizer is opt-in through ``DISTKERAS_SANITIZE``:

* unset / ``0`` / ``false`` — **off**: every guard is a no-op and the
  engines' build-time check is a single cached bool (pinned by test, the
  same zero-cost convention as ``DISTKERAS_TELEMETRY``/``DISTKERAS_DYNAMICS``);
* ``1`` / ``true`` — **record**: violations increment ``sanitizer_*``
  counters in the telemetry registry (and warn once per guard kind), but
  execution continues unchanged;
* ``strict`` — violations raise, naming the enclosing telemetry span.

``mode()`` caches its answer after the first read, exactly like
``telemetry.runtime.enabled()`` — the engines read it once at build and
store the bool, so the per-epoch cost of a disabled sanitizer is zero.
Tests flip the switch with :func:`configure` instead of mutating
``os.environ``.
"""

from __future__ import annotations

import os
import threading
import warnings

__all__ = [
    "MODES",
    "SanitizerViolation",
    "configure",
    "enabled",
    "mode",
    "report",
    "strict",
    "violations",
]

_FALSEY = ("", "0", "false", "no")
MODES = ("off", "record", "strict")

# None = not yet resolved from the environment; one of MODES once resolved
# or forced via configure().
_MODE = None

# record-mode log: (kind, message) tuples, bounded so a hot loop that
# violates every step cannot grow memory without bound
_VIOLATIONS: list = []
_VIOLATIONS_CAP = 200
_WARNED_KINDS: set = set()
_LOCK = threading.Lock()


class SanitizerViolation(RuntimeError):
    """Base class for everything the sanitizer raises in strict mode."""


def mode() -> str:
    """Resolved sanitizer mode; cached after the first environment read."""
    global _MODE
    if _MODE is None:
        raw = os.environ.get("DISTKERAS_SANITIZE", "").lower()
        if raw in _FALSEY:
            _MODE = "off"
        elif raw == "strict":
            _MODE = "strict"
        else:
            _MODE = "record"
    return _MODE


def enabled() -> bool:
    return mode() != "off"


def strict() -> bool:
    return mode() == "strict"


def configure(new_mode=None) -> None:
    """Force the mode (``"off"``/``"record"``/``"strict"``) or reset to
    env-driven (``None``, re-read lazily on the next :func:`mode` call).
    Also clears the recorded-violation log."""
    global _MODE
    if new_mode is not None and new_mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {new_mode!r}")
    with _LOCK:
        _MODE = new_mode
        _VIOLATIONS.clear()
        _WARNED_KINDS.clear()


def violations(kind=None) -> list:
    """Recorded (kind, message) violations, optionally filtered by kind."""
    with _LOCK:
        out = list(_VIOLATIONS)
    if kind is not None:
        out = [v for v in out if v[0] == kind]
    return out


def _flightdeck_note(kind: str, message: str) -> None:
    # Violations land in the flight-recorder ring (and, for strict mode, a
    # blackbox dump) only when telemetry is on — with it off this is one
    # cached-bool check, and report() itself only runs under an active guard.
    from distkeras_tpu_torch.telemetry import runtime as _tel_runtime

    if not _tel_runtime.enabled():
        return
    from distkeras_tpu_torch.telemetry.flightdeck.recorder import recorder as _rec

    _rec.record_sanitizer(kind, message, strict())


def report(kind: str, message: str, exc_type=SanitizerViolation) -> None:
    """Route one violation: raise in strict mode; in record mode bump the
    ``sanitizer_<kind>_violations`` counter, remember the message, and warn
    the first time each kind fires."""
    _flightdeck_note(kind, message)
    if strict():
        from distkeras_tpu_torch.telemetry import runtime as _tel_runtime

        if _tel_runtime.enabled():
            from distkeras_tpu_torch.telemetry.flightdeck.recorder import on_crash

            on_crash(f"sanitizer strict violation [{kind}]: {message}")
        raise exc_type(message)
    # record mode — the counter lives in the telemetry registry so the
    # existing exporters (Prometheus / JSONL / fleet merge) pick it up; the
    # registry is a process-global dict, usable whether or not telemetry
    # file output is on
    from distkeras_tpu_torch.telemetry.metrics import metrics as _registry

    _registry.counter(
        f"sanitizer_{kind}_violations",
        help=f"runtime sanitizer violations ({kind} guard)",
    ).inc()
    with _LOCK:
        if len(_VIOLATIONS) < _VIOLATIONS_CAP:
            _VIOLATIONS.append((kind, message))
        first = kind not in _WARNED_KINDS
        _WARNED_KINDS.add(kind)
    if first:
        warnings.warn(f"sanitizer [{kind}]: {message}", RuntimeWarning,
                      stacklevel=3)
