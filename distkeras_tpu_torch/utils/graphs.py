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
* :func:`wait_bounded`: a replayed collective escapes NCCL's watchdog, so
  a peer that died before its replay leaves the replay waiting for ever,
  and a host that reads its result back blocks with it.  A caller that
  must not hang records an event after its replays and waits on it with
  a deadline; past the deadline it aborts the group's communicator
  (:func:`abort_group`, on a thread of its own, waited for a bounded
  time), which makes the waiting kernel return, and raises.

A capture that fails raises: nothing falls back to eager.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.distributed as dist

from distkeras_tpu_torch.sanitizer import transfer

__all__ = ["CAPTURE_LOCK", "abort_group", "capturing", "require_nccl", "wait_bounded",
           "warm_up", "warm_up_groups"]

#: held around every capture in the process (see the module docstring)
CAPTURE_LOCK = threading.Lock()
#: the longest pause between two polls of :func:`wait_bounded` (seconds)
POLL_MAX_S = 2e-4
#: how long :func:`abort_group` waits for the abort before it returns
ABORT_WAIT_S = 10.0


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


def wait_bounded(event, timeout_s: float, on_timeout, what: str) -> None:
    """Wait until ``event`` (a recorded ``torch.cuda.Event``, or anything
    with ``query()``) has completed, polling it with pauses that double
    from 10 us up to :data:`POLL_MAX_S`.  If ``timeout_s`` seconds pass
    first, call ``on_timeout()`` (:func:`abort_group` of the group whose
    collective waits) and raise ``TimeoutError`` naming ``what``.  The
    host thread is never blocked inside the device, as a read-back of a
    replay's output would be; the pause bounds what the poll adds to a
    wait that ends."""
    deadline = time.monotonic() + float(timeout_s)
    pause = 1e-5
    while not event.query():
        if time.monotonic() >= deadline:
            note = on_timeout()
            raise TimeoutError(
                f"{what} did not complete within {timeout_s} s: a peer of its collectives "
                "is gone (a replayed collective has no watchdog)"
                + (f"; {note}" if note else ""))
        time.sleep(pause)
        pause = min(2 * pause, POLL_MAX_S)


def abort_group(group) -> str:
    """Abort ``group``'s NCCL communicators (None: nothing), so that a
    kernel waiting in one of its collectives, a replayed one included,
    returns; the group is unusable after.  The abort runs on a daemon
    thread and is waited for :data:`ABORT_WAIT_S` at most, so that the caller
    goes on to fail even if it does not return.  Returns what happened, for
    the caller's error."""
    if group is None:
        return "no group to abort"
    done, raised = threading.Event(), []

    def abort():
        try:
            dist.distributed_c10d._abort_process_group(group)
        except Exception as e:  # noqa: BLE001 — reported to the caller
            raised.append(e)
        finally:
            done.set()

    t0 = time.monotonic()
    threading.Thread(target=abort, name="nccl-abort", daemon=True).start()
    if not done.wait(ABORT_WAIT_S):
        return f"its group's abort had not returned after {ABORT_WAIT_S} s"
    if raised:
        return f"its group's abort raised {raised[0]!r}"
    return f"its group was aborted in {time.monotonic() - t0:.3f} s"
