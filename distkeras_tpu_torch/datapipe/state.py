"""DataState — the deterministic data checkpoint.

The port of :mod:`distkeras_tpu.datapipe.state` (framework-neutral, copied):
``to_json`` gives the JAX package's dict, key for key.

A model checkpoint alone resumes training from the *epoch boundary*; the data
plane needs three more facts to resume from the exact block the run died on:
which epoch was in flight, how many window blocks of it were already consumed
(the cursor), and the host RNG's bit-generator state from *before* that
epoch's shuffle.  With those, ``epoch_window_iter(..., start_block=cursor)``
replays the identical permutation and yields exactly the remaining blocks —
the resumed trajectory is bitwise the uninterrupted one
(tests/test_torch_datapipe.py).

The state is a few hundred bytes of JSON (PCG64 state is two 128-bit ints);
:mod:`distkeras_tpu_torch.checkpoint` writes it synchronously as a
``step_<n>_data.json`` sidecar next to the step directory.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

__all__ = ["DataState"]


def _jsonable(obj: Any) -> Any:
    """Recursively coerce numpy scalars inside an rng-state dict to plain
    Python so ``json.dump`` round-trips it exactly (ints are arbitrary
    precision in both directions)."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


@dataclasses.dataclass
class DataState:
    """Position of a training run inside its data stream.

    ``epoch``: the epoch the cursor points into (== the epoch counter of the
    model state saved alongside).  ``block_cursor``: window blocks of that
    epoch already consumed — 0 for an epoch-boundary checkpoint.
    ``rng_state``: ``numpy.random.Generator.bit_generator.state`` captured
    *before* the cursor epoch's shuffle (None when the run doesn't shuffle),
    so the resumed iterator replays the identical permutation.
    """

    epoch: int = 0
    block_cursor: int = 0
    rng_state: Optional[dict] = None

    @classmethod
    def capture(cls, epoch: int, rng: Optional[np.random.Generator],
                block_cursor: int = 0) -> "DataState":
        """Snapshot ``rng`` (if any) at the current stream position."""
        return cls(
            epoch=int(epoch),
            block_cursor=int(block_cursor),
            rng_state=rng.bit_generator.state if rng is not None else None,
        )

    def restore_rng(self, rng: np.random.Generator) -> np.random.Generator:
        """Rewind ``rng`` to the captured bit-generator state (no-op when
        none was captured); returns ``rng`` for chaining."""
        if self.rng_state is not None:
            rng.bit_generator.state = self.rng_state
        return rng

    def to_json(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "block_cursor": int(self.block_cursor),
            "rng_state": _jsonable(self.rng_state),
        }

    @classmethod
    def from_json(cls, d: dict) -> "DataState":
        return cls(
            epoch=int(d["epoch"]),
            block_cursor=int(d["block_cursor"]),
            rng_state=d.get("rng_state"),
        )
