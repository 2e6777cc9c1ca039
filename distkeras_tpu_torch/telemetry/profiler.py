"""Step-windowed ``torch.profiler`` capture.

The port of :mod:`distkeras_tpu.telemetry.profiler`: where the JAX package
starts and stops ``jax.profiler``, the port records ``torch.profiler``
with the CPU activity and, on a machine with a card, the CUDA one (its
kernels, the port's own flash-attention kernels among them, with their
device times), and writes the capture as one Chrome trace
``profile_<pid>_<n>.json`` into ``logdir`` (open it in Perfetto).

Opt-in via ``DISTKERAS_PROFILE=<dir>`` (plus optional
``DISTKERAS_PROFILE_STEPS=<start>:<stop>``, default ``1:2`` — skip epoch 0
so warm-up stays out of the capture).  The trainer calls ``on_step(epoch)``
at the top of each epoch and ``close()`` when done; the hook starts and
stops the profiler exactly once over the half-open window ``[start,
stop)``.  :func:`profile` is the one-shot form the trainers' ``profile_dir=``
uses around one epoch.

``torch.profiler`` is imported when a capture starts, so this module stays
importable (and testable by monkeypatching ``_start``/``_stop``) anywhere.
"""

from __future__ import annotations

import contextlib
import itertools
import os

__all__ = ["ProfilerHook", "kernel_times", "profile"]

_CAPTURES = itertools.count()


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def profile(logdir):
    """Profile the ``with`` body and write its Chrome trace into ``logdir``;
    the path is left on the yielded dict's ``"path"`` once the body ends.
    The card is synchronised before the capture stops, so the body's
    kernels are in it."""
    import torch

    os.makedirs(logdir, exist_ok=True)
    out = {"path": None}
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"profile_{os.getpid()}_{next(_CAPTURES)}.json")
        prof.export_chrome_trace(path)
        out["path"] = path


def kernel_times(path) -> dict:
    """Device microseconds by kernel name in a Chrome trace :func:`profile`
    wrote (its ``"cat": "kernel"`` events)."""
    import json

    with open(path, encoding="utf-8") as fh:
        events = json.load(fh).get("traceEvents", [])
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    return out


class ProfilerHook:
    """Start/stop ``torch.profiler`` over a step (epoch) range."""

    def __init__(self, logdir, start_step=1, stop_step=None):
        self.logdir = logdir
        self.start_step = int(start_step)
        self.stop_step = int(stop_step) if stop_step is not None else self.start_step + 1
        if self.stop_step <= self.start_step:
            raise ValueError("stop_step must be > start_step")
        self.active = False
        self.done = False
        self._capture = None
        #: the Chrome trace written when the capture stopped
        self.path = None

    @classmethod
    def from_env(cls):
        """Build from ``DISTKERAS_PROFILE`` / ``DISTKERAS_PROFILE_STEPS``;
        None when profiling is not requested."""
        logdir = os.environ.get("DISTKERAS_PROFILE")
        if not logdir:
            return None
        steps = os.environ.get("DISTKERAS_PROFILE_STEPS", "1:2")
        try:
            lo, _, hi = steps.partition(":")
            start, stop = int(lo), int(hi) if hi else int(lo) + 1
        except ValueError:
            raise ValueError(
                f"DISTKERAS_PROFILE_STEPS must be 'start:stop', got {steps!r}"
            ) from None
        return cls(logdir, start, stop)

    # Separated so tests can monkeypatch without a real profiler session.
    def _start(self):
        self._capture = profile(self.logdir)
        self._out = self._capture.__enter__()

    def _stop(self):
        self._capture.__exit__(None, None, None)
        self.path = self._out["path"]
        self._capture = None

    def on_step(self, step) -> None:
        """Call at the top of each step/epoch with its index."""
        if self.active and step >= self.stop_step:
            self._stop()
            self.active = False
            self.done = True
        if (not self.active and not self.done
                and self.start_step <= step < self.stop_step):
            self._start()
            self.active = True

    def close(self) -> None:
        """Stop the capture if the run ended inside the window."""
        if self.active:
            self._stop()
            self.active = False
            self.done = True
