"""CUDA-graph capture: the port's counterpart of a jitted program.

JAX compiles a training window, the staleness simulation's epoch and the
serving engine's decode, verify and prefill steps as whole programs; on a
card the port captures each as a CUDA graph once and replays it.  The
engines share what every capture needs:

* :data:`CAPTURE_LOCK`, one process-wide lock around every capture.
  Entering ``torch.cuda.graph`` synchronises the device and empties the
  allocator's cache, so two captures must never overlap: the serving tier's
  replicas are threads of one process, and the online loop retrains beside
  them.  Eager work on other threads goes on meanwhile (captures run with
  ``capture_error_mode="thread_local"``).
* :func:`warm_up`: one eager run of the body on a side stream before its
  capture, so that lazy initialisation (cuBLAS handles, workspaces) never
  happens inside one.
* :func:`capturing`: the capture itself, its set-up's device sync declared
  to the transfer guard (``"graph capture set-up"``); the captured body is
  not declared.

A capture that fails raises: nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from distkeras_tpu_torch.sanitizer import transfer

__all__ = ["CAPTURE_LOCK", "capturing", "warm_up"]

#: held around every capture in the process (see the module docstring)
CAPTURE_LOCK = threading.Lock()


def warm_up(fn, device):
    """Run ``fn()`` once on a side stream ordered after the current one,
    and order the current stream after it; returns what ``fn`` returns."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


@contextlib.contextmanager
def capturing(graph, pool=None):
    """Capture the block into ``graph`` (``pool``: a memory pool shared with
    other graphs, ``torch.cuda.graph_pool_handle()``).  Hold
    :data:`CAPTURE_LOCK` around it."""
    capture = torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local")
    # entering synchronises the device (torch.cuda.graph's own set-up)
    with transfer.allow("graph capture set-up"):
        capture.__enter__()
    with contextlib.ExitStack() as stack:
        stack.push(capture)
        yield
