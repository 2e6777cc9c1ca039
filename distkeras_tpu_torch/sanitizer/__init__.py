"""``distkeras_tpu_torch.sanitizer`` — runtime twins of dklint's static
rules: the port of :mod:`distkeras_tpu.sanitizer`.

Enabled by ``DISTKERAS_SANITIZE=1`` (record) or ``strict`` (raise):

* :mod:`.transfer` — DK101's twin: the engine's epoch runs under a transfer
  guard (on a card in strict mode, torch's sync debug mode; everywhere, an
  interposition on ``torch.Tensor``'s host-read methods), so a host sync
  hidden in the hot loop raises (strict) or bumps
  ``sanitizer_transfer_violations`` (record), with the enclosing telemetry
  span named;
* :mod:`.donation` — DK103's twin: the engine's epoch consumes its input
  state in place, and the consumed state object is poisoned at the epoch
  boundary, so a stale read raises instead of silently seeing the updated
  tensors;
* :mod:`.lockwatch` — DK105's twin: wrapped locks record per-thread
  acquisition order (inversions and off-lock cv-waits are flagged), and
  guarded shared dicts/sockets catch off-lock mutation and torn frames.

All guards collapse to no-ops when the flag is off; the engines read the
mode once at build (``self._sanitize``) so the disabled path stays a single
cached bool, no ``torch.Tensor`` method is patched, and the trajectory is
the same bit for bit on, off and strict (pinned in
tests/test_torch_sanitizer.py).
"""

from __future__ import annotations

from distkeras_tpu_torch.sanitizer import donation, lockwatch, runtime, transfer
from distkeras_tpu_torch.sanitizer.lockwatch import LockOrderViolation
from distkeras_tpu_torch.sanitizer.runtime import (
    SanitizerViolation,
    configure,
    enabled,
    mode,
    report,
    strict,
    violations,
)
from distkeras_tpu_torch.sanitizer.transfer import TransferViolation

__all__ = [
    "LockOrderViolation",
    "SanitizerViolation",
    "TransferViolation",
    "configure",
    "donation",
    "enabled",
    "lockwatch",
    "mode",
    "report",
    "runtime",
    "strict",
    "transfer",
    "violations",
]
