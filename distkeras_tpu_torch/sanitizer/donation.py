"""Donation guard — DK103's runtime twin: the port of
:mod:`distkeras_tpu.sanitizer.donation`.

The JAX engine's epoch program donates its input state; a read of the
donated handles afterwards fails where donation aliases and silently reads
stale values where it does not, which the JAX guard closes by deleting them.
The port's ``run_epoch`` **consumes its input state in place**: the returned
state holds the same tensors, updated.  So a read of the caller's old
``TrainState`` after the call silently sees the *new* values — the same
latent bug, from the other side.

:func:`poison` closes it by marking the consumed state object itself: its
class becomes a poisoned subclass whose every field read raises
:class:`~distkeras_tpu_torch.sanitizer.runtime.SanitizerViolation`, naming
the label.  The tensors are never touched — the returned state shares them
— and the check costs nothing on a live state (the class swap is the whole
mechanism).
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from distkeras_tpu_torch.sanitizer import runtime
from distkeras_tpu_torch.sanitizer.runtime import SanitizerViolation
from distkeras_tpu_torch.utils.pytree import tree_leaves

__all__ = ["poison", "poisoned", "stats", "reset_stats"]

KIND = "donation"

_lock = threading.Lock()
_stats = {"poisoned": 0, "already_deleted": 0, "boundaries": 0}
_classes: dict = {}


def _poisoned_class(cls):
    """The poisoned twin of the dataclass ``cls`` (made once per class): a
    subclass whose field reads raise."""
    with _lock:
        twin = _classes.get(cls)
        if twin is not None:
            return twin
        fields = frozenset(f.name for f in dataclasses.fields(cls))

        def __getattribute__(self, name):
            if name in fields:
                label = object.__getattribute__(self, "_sanitizer_label")
                raise SanitizerViolation(
                    f"read of '{name}' on a consumed {cls.__name__} ({label}): "
                    "the call that took it updated its tensors in place and "
                    "returned the live state; read that one"
                )
            return object.__getattribute__(self, name)

        twin = type(f"Consumed{cls.__name__}", (cls,), {
            "__getattribute__": __getattribute__,
            "__repr__": lambda self: f"<consumed {cls.__name__}>",
        })
        _classes[cls] = twin
        return twin


def poisoned(state) -> bool:
    """True when ``state`` was consumed and poisoned."""
    return type(state) in _classes.values()


def poison(state, label: str = "consumed state") -> int:
    """Poison a consumed state object (a dataclass instance, such as the
    engine's ``TrainState``) so that any later read of its fields raises.

    Returns how many tensor leaves the caller was cut off from (each one a
    read that would have seen the updated values), counted in the
    ``sanitizer_donation_poisoned`` counter; a state poisoned before counts
    its leaves as ``already_deleted``.  No-op when the sanitizer is off."""
    if not runtime.enabled():
        return 0
    if not dataclasses.is_dataclass(state) or isinstance(state, type):
        raise TypeError(f"poison takes a dataclass instance, got {type(state).__name__}")
    if poisoned(state):
        poisoned_now, already = 0, len(_tensor_leaves(_fields_of(state)))
    else:
        poisoned_now, already = len(_tensor_leaves(_fields_of(state))), 0
        object.__setattr__(state, "_sanitizer_label", label)
        state.__class__ = _poisoned_class(type(state))
    with _lock:
        _stats["poisoned"] += poisoned_now
        _stats["already_deleted"] += already
        _stats["boundaries"] += 1
    if poisoned_now:
        from distkeras_tpu_torch.telemetry.metrics import metrics as _registry

        _registry.counter(
            "sanitizer_donation_poisoned",
            help="donated-but-still-live buffers the sanitizer poisoned",
        ).inc(poisoned_now)
    return poisoned_now


def _fields_of(state) -> list:
    return [object.__getattribute__(state, f.name) for f in dataclasses.fields(state)]


def _tensor_leaves(tree) -> list:
    return [leaf for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor)]


def stats() -> dict:
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for k in _stats:
            _stats[k] = 0
