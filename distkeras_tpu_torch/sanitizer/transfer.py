"""Transfer guard — DK101's runtime twin: the port of
:mod:`distkeras_tpu.sanitizer.transfer`.

Wraps the epoch's device work so a host<->device round-trip inside the hot
loop is caught *as it executes*.  The JAX guard wraps one jitted dispatch;
here the epoch runs eagerly from Python, step by step, so the guard covers
every launch of it.  Two layers, as in JAX:

* **On a card, in strict mode**: ``torch.cuda.set_sync_debug_mode("error")``
  for the guard's extent, the counterpart of ``jax.transfer_guard
  ("disallow")``: every synchronising CUDA call (a blocking copy either way,
  a stream or device synchronise, an op whose output size depends on the
  data such as ``torch.nonzero``) raises, and its ``RuntimeError`` is
  re-raised as :class:`TransferViolation` naming the innermost open
  telemetry span, else the guard's label.  The mode is **process-wide** in
  torch: while a strict guard is open, a sync on any thread raises.  A
  thread whose syncs are by design (the serving engine's read-backs, the
  gloo collectives' host staging, entering a CUDA-graph capture) declares
  them with :func:`allow`, which disarms this layer for its extent, for
  every thread: a declared transfer opens a blind window, never a false
  report.
* **Everywhere, and so in the CPU tests**: an interposition on
  ``torch.Tensor``'s ``item``/``tolist``/``numpy``/``__float__``/
  ``__int__``/``__index__``/``__array__``.  While a guard is open on the
  *current thread* (a thread-local depth), any of these is a host read of a
  tensor hidden in the hot loop and is reported with the innermost open
  span attached.  Other threads are not watched by this layer.

The interposition is installed once, only when a guard opens with the
sanitizer on: a process with the sanitizer off patches nothing.  The
patched methods cost one thread-local read when no guard is open.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from distkeras_tpu_torch.sanitizer import runtime
from distkeras_tpu_torch.sanitizer.runtime import SanitizerViolation

__all__ = ["TransferViolation", "allow", "guard", "installed", "reset_stats", "stats"]

KIND = "transfer"

# torch.Tensor methods that read a tensor's values on the host (mirrors
# DK101's HOST_SYNC_METHODS; ``numpy`` is torch's spelling of a host read)
_SYNC_METHODS = ("item", "tolist", "numpy", "__float__", "__int__", "__index__",
                 "__array__")

#: what torch's sync debug mode raises with
_SYNC_ERROR = "synchronizing CUDA operation"

_tls = threading.local()  # .depth, .allowed (ints), .label (str)
_install_lock = threading.Lock()
_installed = False

# the card layer: strict guards open and declared regions open, process-wide
_card_lock = threading.Lock()
_card = {"guards": 0, "allows": 0, "prev": 0}

_stats_lock = threading.Lock()
_declared: dict = {}


class TransferViolation(SanitizerViolation):
    """A host<->device transfer executed inside a guarded hot loop."""


def _span_context(label):
    """'span <name>' when a telemetry span is open on this thread, else the
    guard's static label — the violation message must name where in the
    pipeline the sync happened either way."""
    from distkeras_tpu_torch import telemetry

    span = telemetry.trace.current()
    return f"span '{span}'" if span else f"guard '{label}'"


def _violate(what):
    label = getattr(_tls, "label", "?")
    runtime.report(
        KIND,
        f"host transfer inside the hot loop ({_span_context(label)}): {what}",
        TransferViolation,
    )


def _wrap(name, orig):
    def guarded(self, *args, **kwargs):
        if getattr(_tls, "depth", 0) and not getattr(_tls, "allowed", 0):
            _violate(f"torch.Tensor.{name}() reads the tensor on the host "
                     f"({self.device.type} tensor)")
        return orig(self, *args, **kwargs)

    guarded.__name__ = name
    guarded.__qualname__ = f"Tensor.{name}"
    guarded.__wrapped__ = orig
    return guarded


def _install():
    """Patch ``torch.Tensor`` once per process (sanitizer on only): every
    tensor class, ``nn.Parameter`` included, inherits the patched methods."""
    global _installed
    with _install_lock:
        if _installed:
            return
        for name in _SYNC_METHODS:
            orig = getattr(torch.Tensor, name, None)
            if orig is not None:
                setattr(torch.Tensor, name, _wrap(name, orig))
        _installed = True


def installed() -> bool:
    """True once this process has patched ``torch.Tensor`` (never with the
    sanitizer off)."""
    return _installed


def _card_update(guards: int = 0, allows: int = 0) -> None:
    """Move the card layer's counts and set torch's sync debug mode to match:
    ``error`` while a strict guard is open and no declared region is, the
    mode found before the first guard otherwise."""
    with _card_lock:
        c = _card
        was = c["guards"] > 0 and c["allows"] == 0
        if c["guards"] == 0 and guards > 0:
            c["prev"] = torch.cuda.get_sync_debug_mode()
        c["guards"] += guards
        c["allows"] += allows
        now = c["guards"] > 0 and c["allows"] == 0
        if now != was:
            torch.cuda.set_sync_debug_mode("error" if now else c["prev"])


def _card_layer() -> bool:
    return runtime.strict() and torch.cuda.is_available()


@contextlib.contextmanager
def guard(label: str):
    """Guard the dynamic extent of one hot-loop run.

    No-op when the sanitizer is off.  In strict mode on a card, torch's
    sync debug mode is armed as well, and its errors are re-raised as
    :class:`TransferViolation` with the span context attached.  Guards nest;
    the previous sync debug mode is restored when the last one closes."""
    if not runtime.enabled():
        yield
        return
    _install()
    prev_label = getattr(_tls, "label", None)
    _tls.label = label
    _tls.depth = getattr(_tls, "depth", 0) + 1
    card = _card_layer()
    if card:
        _card_update(guards=1)
    try:
        yield
    except TransferViolation:
        raise
    except RuntimeError as e:
        text = str(e)
        if card and _SYNC_ERROR in text:
            raise TransferViolation(
                f"host transfer inside the hot loop ({_span_context(label)}): "
                f"{text.splitlines()[0]}"
            ) from e
        raise
    finally:
        if card:
            _card_update(guards=-1)
        _tls.depth -= 1
        _tls.label = prev_label


@contextlib.contextmanager
def allow(reason: str):
    """Declare a transfer (or host wait) that is there by design: inside it
    neither layer reports, on the card for every thread (see the module
    docstring).  Counted per ``reason`` in :func:`stats`.  No-op when the
    sanitizer is off."""
    if not runtime.enabled():
        yield
        return
    with _stats_lock:
        _declared[reason] = _declared.get(reason, 0) + 1
    _tls.allowed = getattr(_tls, "allowed", 0) + 1
    card = _card_layer()
    if card:
        _card_update(allows=1)
    try:
        yield
    finally:
        if card:
            _card_update(allows=-1)
        _tls.allowed -= 1


def stats() -> dict:
    """``{"declared": {reason: count}}``: the declared transfers entered."""
    with _stats_lock:
        return {"declared": dict(_declared)}


def reset_stats() -> None:
    with _stats_lock:
        _declared.clear()
