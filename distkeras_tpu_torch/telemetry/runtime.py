"""Telemetry on/off switch and output-directory resolution.

The port of :mod:`distkeras_tpu.telemetry.runtime`: recording is on only
when ``DISTKERAS_TELEMETRY`` is set to a non-empty value other than
``0``/``false``/``no``.  A value of ``1``/``true`` enables with the default
output directory; any other value enables and names the output directory
(``DISTKERAS_TELEMETRY=/tmp/run1``), with ``DISTKERAS_TELEMETRY_DIR`` as the
explicit override.  ``enabled()`` is cached after its first read; tests
flip it with ``configure()`` instead of mutating ``os.environ``.
"""

from __future__ import annotations

import os

__all__ = ["configure", "enabled", "out_dir"]

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


def out_dir() -> str:
    """Directory where ``flush()`` writes trace and metrics files.

    Priority: ``DISTKERAS_TELEMETRY_DIR``, then a path-valued
    ``DISTKERAS_TELEMETRY``, then ``./distkeras_telemetry``.
    """
    explicit = os.environ.get("DISTKERAS_TELEMETRY_DIR")
    if explicit:
        return explicit
    v = os.environ.get("DISTKERAS_TELEMETRY", "")
    if v.lower() not in _FALSEY + ("1", "true", "yes"):
        return v
    return "distkeras_telemetry"
