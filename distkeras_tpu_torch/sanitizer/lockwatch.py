"""Lock-order watchdog — DK105's runtime twin: the port of
:mod:`distkeras_tpu.sanitizer.lockwatch` (host code, copied).

Instruments the threaded locking of the serving engine, ``networking`` and
the Punchcard daemon (``job_deployment``):

* :func:`maybe_wrap` proxies a ``threading.Lock``/``Condition`` so every
  acquisition records into a per-thread held-set and a process-global
  acquisition-order graph.  Acquiring B while holding A records the edge
  A->B; a later acquire of A while holding B is an **inversion** (the
  classic two-thread deadlock shape) and is reported.  A ``cv.wait()`` or
  ``notify()`` without holding the wrapped lock is reported too (the lost
  wakeup DK105 hunts statically);
* :func:`guard_map` wraps a dict shared across threads so any *mutation*
  off the owning lock is reported — the direct runtime analogue of DK105's
  "guarded attribute written outside the lock";
* :func:`exclusive` guards single-owner resources (a socket carrying
  length-prefixed frames): concurrent use from two threads interleaves
  frames on the wire, a corruption DK105 cannot see statically.

Everything returns the raw object / is a no-op when the sanitizer is off,
so the disabled path runs on the stock ``threading`` types.
"""

from __future__ import annotations

import threading

from distkeras_tpu_torch.sanitizer import runtime
from distkeras_tpu_torch.sanitizer.runtime import SanitizerViolation

__all__ = [
    "LockOrderViolation",
    "GuardedLock",
    "GuardedMap",
    "exclusive",
    "guard_map",
    "maybe_wrap",
    "reset",
]

KIND = "lock"


class LockOrderViolation(SanitizerViolation):
    """Lock-order inversion, off-lock wait/notify, or off-lock mutation."""


class _Watch:
    """Process-global acquisition bookkeeping shared by every wrapped lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._edges = set()  # (first, second) lock names, acquisition order
        self._tls = threading.local()

    def held(self):
        stack = getattr(self._tls, "held", None)
        if stack is None:
            stack = self._tls.held = []
        return stack

    def before_acquire(self, name):
        held = self.held()
        for h in held:
            if h == name:
                continue
            with self._lock:
                inverted = (name, h) in self._edges
                self._edges.add((h, name))
            if inverted:
                runtime.report(
                    KIND,
                    f"lock-order inversion: acquiring '{name}' while holding "
                    f"'{h}', but the opposite order '{name}' -> '{h}' was "
                    "also observed — two threads interleaving these paths "
                    "deadlock",
                    LockOrderViolation,
                )

    def acquired(self, name):
        self.held().append(name)

    def released(self, name):
        held = self.held()
        # release-from-anywhere: remove the most recent matching entry
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def holds(self, name):
        return name in self.held()

    def reset(self):
        with self._lock:
            self._edges.clear()


_watch = _Watch()


def reset() -> None:
    """Clear the global acquisition-order graph (tests)."""
    _watch.reset()


class GuardedLock:
    """Proxy around a ``threading.Lock``/``RLock``/``Condition`` feeding the
    watchdog.  Supports the full Condition surface so it drops in for
    ``ServingEngine._cv``."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self._name = name

    # -- lock surface -------------------------------------------------------
    def acquire(self, *args, **kwargs):
        _watch.before_acquire(self._name)
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _watch.acquired(self._name)
        return got

    def release(self):
        _watch.released(self._name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def holds(self) -> bool:
        """True when the calling thread holds this lock (watchdog view)."""
        return _watch.holds(self._name)

    # -- condition surface --------------------------------------------------
    def _require_held(self, op):
        if not _watch.holds(self._name):
            runtime.report(
                KIND,
                f"{op} on '{self._name}' without holding it — the wakeup "
                "(or the predicate it protects) races",
                LockOrderViolation,
            )

    def wait(self, timeout=None):
        self._require_held(f"cv.wait(timeout={timeout})")
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        self._require_held("cv.wait_for()")
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n=1):
        self._require_held("cv.notify()")
        return self._inner.notify(n)

    def notify_all(self):
        self._require_held("cv.notify_all()")
        return self._inner.notify_all()


def maybe_wrap(lock, name: str):
    """Wrap ``lock`` in a :class:`GuardedLock` when the sanitizer is on;
    return it untouched otherwise."""
    if not runtime.enabled():
        return lock
    return GuardedLock(lock, name)


class GuardedMap(dict):
    """Dict whose mutations must happen while ``lock`` is held by the
    calling thread (reads stay free — CPython dict reads are atomic and
    status polls rely on that).

    Known blind spot: only mutations of *this* mapping are policed.
    Mutating a value fetched from it (``guarded[k]["field"] = v``) is an
    ordinary inner-dict write the guard never sees (a job record's
    ``status`` flipped off-lock, say).  Discipline for nested state must
    hold by construction: fetch under the lock, mutate under the lock."""

    def __init__(self, data, lock: GuardedLock, name: str):
        super().__init__(data)
        self._lock = lock
        self._name = name

    def _check(self, op):
        if not self._lock.holds():
            runtime.report(
                KIND,
                f"off-lock write: {op} on '{self._name}' without holding "
                f"'{self._lock._name}'",
                LockOrderViolation,
            )

    def __setitem__(self, key, value):
        self._check(f"[{key!r}] = ...")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        self._check(f"del [{key!r}]")
        super().__delitem__(key)

    def pop(self, *args):
        self._check("pop()")
        return super().pop(*args)

    def popitem(self):
        self._check("popitem()")
        return super().popitem()

    def clear(self):
        self._check("clear()")
        return super().clear()

    def update(self, *args, **kwargs):
        self._check("update()")
        return super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        self._check(f"setdefault({key!r})")
        return super().setdefault(key, default)


def guard_map(data, lock, name: str):
    """A :class:`GuardedMap` over ``data`` when the sanitizer is on AND the
    lock is wrapped; the plain dict otherwise."""
    if not runtime.enabled() or not isinstance(lock, GuardedLock):
        return dict(data)
    return GuardedMap(data, lock, name)


# -- single-owner resources (sockets) ---------------------------------------

_excl_lock = threading.Lock()
_excl = {}  # (id(resource), operation) -> (thread ident, depth)


class _Exclusive:
    """Context manager asserting single-threaded use of one resource for
    the duration of an operation (e.g. one length-prefixed frame).  Keyed
    by (resource, operation) so full-duplex use — one thread sending while
    another receives — stays legal; only same-direction concurrency tears
    the framing."""

    __slots__ = ("_obj", "_what", "_active")

    def __init__(self, obj, what):
        self._obj = obj
        self._what = what
        self._active = False

    def __enter__(self):
        if not runtime.enabled():
            return self
        me = threading.get_ident()
        key = (id(self._obj), self._what)
        with _excl_lock:
            owner = _excl.get(key)
            if owner is None:
                _excl[key] = (me, 1)
                self._active = True
            elif owner[0] == me:
                _excl[key] = (me, owner[1] + 1)
                self._active = True
        if not self._active:
            runtime.report(
                KIND,
                f"concurrent {self._what} from two threads — length-prefixed "
                "frames interleave on the wire and the stream is torn",
                LockOrderViolation,
            )
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._active:
            key = (id(self._obj), self._what)
            with _excl_lock:
                tid, depth = _excl[key]
                if depth <= 1:
                    del _excl[key]
                else:
                    _excl[key] = (tid, depth - 1)
        return False


def exclusive(obj, what: str) -> _Exclusive:
    return _Exclusive(obj, what)
