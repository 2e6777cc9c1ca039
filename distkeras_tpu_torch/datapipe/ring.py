"""PrefetchRing — bounded background prefetch over a window-block iterator.

The port of :mod:`distkeras_tpu.datapipe.ring` (framework-neutral, copied;
the port has no metrics registry yet, so the ring's counters are its
``blocks`` and ``stall_seconds`` attributes).

``run_epoch_streaming`` already double-buffers: async dispatch lets the
*current* block's compute overlap the *next* block's host gather — but the
gather itself still runs on the dispatching thread, so a slow source inserts
its latency into the dispatch loop.  The ring moves the pull onto a worker
thread: blocks flow ``source -> [producer thread: gather (+ optional
device-put)] -> bounded queue -> consumer``, and the consumer is any code
written against the plain iterator contract — ``run_epoch_streaming`` feeds
from a ring with zero changes.

Guarantees (tests/test_torch_datapipe.py):

* **Bitwise parity** — the ring reorders nothing and touches no block
  payload; the trajectory through ``epoch_window_iter`` + ring is the
  non-prefetched trajectory, bit for bit (float32 and fused-bf16 gathers).
* **No hangs, no orphans** — every queue wait is timeout-bounded (anything
  unbounded in this loop would stall training end-to-end).  A producer exception is captured and re-raised at the
  consumer's next pull; ``close()`` (also the generator-protocol ``close``
  that ``run_epoch_streaming``'s try/finally calls) drains the queue and
  joins the thread.
* **Observability** — with telemetry on, gathers record spans on the
  producer thread; ``ring.blocks`` counts the blocks delivered and
  ``ring.stall_seconds`` the consumer's wait on an empty ring.

The optional ``put_fn`` (typically ``engine.stream_put``) runs the host→device
copy on the producer thread too, so it overlaps the next gather; the engine
recognises blocks that were put already and skips its own put.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from distkeras_tpu_torch import telemetry

__all__ = ["PrefetchRing"]

# Wait quantum for every blocking queue op: long enough to cost nothing
# measurable, short enough that close() is honoured promptly.
_TICK = 0.05

# End-of-stream marker (identity-compared; never leaks to the consumer).
_END = object()


class PrefetchRing:
    """Iterate ``window_iter``'s blocks through a ``depth``-bounded queue
    filled by a background thread.  Iterator in, iterator out — drop-in for
    :meth:`WindowedEngine.run_epoch_streaming`'s ``window_iter`` argument."""

    def __init__(self, window_iter, depth: int = 2,
                 put_fn: Optional[Callable] = None):
        self._it = iter(window_iter)
        self._put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._closed = threading.Event()
        self._exc: Optional[BaseException] = None
        #: blocks delivered to the consumer so far
        self.blocks = 0
        #: cumulative seconds the consumer waited on an empty ring
        self.stall_seconds = 0.0
        self._thread = threading.Thread(
            target=self._produce, name="datapipe-prefetch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _produce(self):
        try:
            while not self._closed.is_set():
                # No phase= on this span: the underlying epoch_window_iter
                # records its own window_gather spans (phase="data") nested
                # inside — both land on THIS thread's tid, which is what
                # makes gather/step overlap visible in the merged trace.
                with telemetry.trace.span("datapipe_gather"):
                    try:
                        block = next(self._it)
                    except StopIteration:
                        break
                if self._put_fn is not None:
                    # the copy to the card off the dispatch thread: it now
                    # overlaps the next gather as well as the device compute
                    block = self._put_fn(block)
                if not self._offer(block):
                    return  # closed while waiting: drop the tail, exit
        except BaseException as e:  # re-raised at the consumer's next pull
            self._exc = e
        self._offer(_END)

    def _offer(self, item) -> bool:
        """Bounded-wait put: retries in _TICK quanta so a close() during
        backpressure is honoured instead of deadlocking the producer."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=_TICK)
                return True
            except queue.Full:
                continue
        return False

    # ------------------------------------------------------------- consumer
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=_TICK)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    # producer gone: drain whatever it left, then finish
                    try:
                        item = self._q.get(block=False)
                    except queue.Empty:
                        item = _END
                    break
                continue
        self.stall_seconds += time.perf_counter() - t0
        if item is _END:
            self.close()
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            raise StopIteration
        self.blocks += 1
        return item

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Stop the producer and join it.  Idempotent; also the generator
        protocol hook run_epoch_streaming's try/finally calls, so a trainer
        error drains the ring instead of orphaning the thread."""
        self._closed.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                self._q.get(block=False)
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False
