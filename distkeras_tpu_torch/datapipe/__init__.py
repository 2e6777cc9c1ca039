"""Data plane — sharded, prefetching, resumable input pipeline.

The port of :mod:`distkeras_tpu.datapipe` but for sequence packing
(``packing.py``, with ``TransformerLM(packed=True)``), which stays in
ROADMAP Queue A item 11:

* :mod:`~distkeras_tpu_torch.datapipe.source` — where rows live: in-memory
  arrays / DataFrame columns, or memory-mapped ``.npy`` file shards, each
  process holding only its slice.
* :mod:`~distkeras_tpu_torch.datapipe.ring` — :class:`PrefetchRing`, a
  bounded background-thread ring that pulls blocks through
  ``epoch_window_iter`` (bitwise the same row order) and optionally runs the
  engine's copy to the card off-thread, feeding ``run_epoch_streaming``.
* :mod:`~distkeras_tpu_torch.datapipe.state` — :class:`DataState`, the data
  checkpoint (epoch, block cursor, numpy bit-generator state) saved next to
  model checkpoints, so a killed run resumes mid-epoch on the identical
  remaining blocks.
"""

from distkeras_tpu_torch.datapipe.ring import PrefetchRing
from distkeras_tpu_torch.datapipe.source import (
    ArraySource,
    MemmapSource,
    Source,
    atomic_write_npy,
    host_shard,
)
from distkeras_tpu_torch.datapipe.state import DataState

__all__ = [
    "ArraySource",
    "DataState",
    "MemmapSource",
    "PrefetchRing",
    "Source",
    "atomic_write_npy",
    "host_shard",
]
