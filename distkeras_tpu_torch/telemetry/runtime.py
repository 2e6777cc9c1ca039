"""Telemetry on/off switch.

The port of :mod:`distkeras_tpu.telemetry.runtime`'s switch: recording is
on only when ``DISTKERAS_TELEMETRY`` is set to a non-empty value other than
``0``/``false``/``no``.  ``enabled()`` is cached after its first read; tests
flip it with ``configure()`` instead of mutating ``os.environ``.
"""

from __future__ import annotations

import os

__all__ = ["configure", "enabled"]

_FALSEY = ("", "0", "false", "no")

# None = not yet resolved from the environment; True/False once resolved or
# forced via configure().
_ENABLED = None


def enabled() -> bool:
    """True when telemetry recording is on.  Cached after first read."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("DISTKERAS_TELEMETRY", "").lower() not in _FALSEY
    return _ENABLED


def configure(on=None) -> None:
    """Force telemetry on/off (``True``/``False``) or reset to env-driven
    (``None``, re-read lazily on the next ``enabled()`` call)."""
    global _ENABLED
    _ENABLED = on
