"""CUDA-graph capture: the port's counterpart of a jitted program.

JAX compiles a training window, the staleness simulation's epoch and the
serving engine's decode, verify and prefill steps as whole programs, their
collectives included; on a card the port captures each as a CUDA graph once
and replays it.  The engines share what every capture needs:

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
* Collectives inside a graph (a mesh's commit, the ring's hops, tensor
  parallelism's gathers and psums, the serving mesh's all-reduce a block):
  only NCCL's can be recorded, since gloo moves a CUDA tensor through host
  memory (:func:`require_nccl` refuses a gloo group when an engine is
  built), and NCCL records a collective only over a communicator that
  exists, which :func:`warm_up_groups` makes for every group a body uses
  before its capture.  A recorded collective runs at each replay, so every
  rank of a group must capture the same programs in the same order and
  replay them in lockstep, as the engines' SPMD loops do.  NCCL does not
  destroy a communicator while a graph that recorded its collectives
  lives: ``networking.shutdown`` frees the unreachable ones first.

A capture that fails raises: nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from distkeras_tpu_torch.sanitizer import transfer

__all__ = ["CAPTURE_LOCK", "capturing", "require_nccl", "warm_up", "warm_up_groups"]

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


def _distinct(groups) -> list:
    """The groups that are not None, each once, in their first order."""
    out = []
    for g in groups:
        if g is not None and not any(g is h for h in out):
            out.append(g)
    return out


def require_nccl(groups, what: str, remedy: str) -> None:
    """Raise ``ValueError`` unless every group of ``groups`` (None: no
    collective) runs NCCL: ``what`` holds their collectives inside a CUDA
    graph, and gloo stages a CUDA tensor through host memory, which a
    capture cannot record.  ``remedy`` says what to do instead."""
    for group in _distinct(groups):
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(
                f"{what} hold their collectives inside the CUDA graph, and only NCCL "
                f"collectives can be captured; this mesh's group runs {backend}: {remedy}"
            )


def warm_up_groups(groups, device) -> None:
    """Make the NCCL communicator of every group of ``groups`` (None
    skipped): one all-reduce of one element on each, in the given order,
    then a device sync (declared to the transfer guard as the capture's
    set-up).  A collective over a group with no communicator yet cannot be
    recorded.  Every rank of each group makes the call, in the same order,
    before the same capture."""
    groups = _distinct(groups)
    if not groups:
        return
    for group in groups:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    with transfer.allow("graph capture set-up"):
        torch.cuda.synchronize(device)


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
