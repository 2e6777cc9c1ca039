"""Host-side batching: DataFrame columns -> epoch arrays.

The port of :mod:`distkeras_tpu.data` (``plan_epoch`` and ``epoch_arrays``):
the engine wants the whole epoch as one array ``[num_workers, n_windows,
window, batch, ...]``, built with wrap-around padding (no sample dropped)
and a per-epoch shuffle drawn from a numpy ``Generator``.  The same
generator gives bitwise the same arrays as the JAX package.  The gather is
numpy's ``features[idx]``; the JAX package's multithreaded native gather
(bit-identical to it) and the streaming ``epoch_window_iter`` come with
ROADMAP Queue A item 11.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from distkeras_tpu_torch import telemetry

__all__ = ["epoch_arrays", "plan_epoch"]


def plan_epoch(n: int, num_workers: int, batch_size: int, window: int) -> Tuple[int, int]:
    """(n_windows, padded_total): smallest window grid covering all n samples."""
    window = max(1, window)
    per_step = num_workers * batch_size
    steps = max(1, -(-n // per_step))  # ceil
    n_windows = max(1, -(-steps // window))
    return n_windows, n_windows * window * per_step


def epoch_arrays(
    features: np.ndarray,
    labels: np.ndarray,
    num_workers: int,
    batch_size: int,
    window: int,
    *,
    stepwise: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffle + wrap-pad + reshape one epoch of data.

    Uniform mode: leaves shaped ``[num_workers, n_windows, window, batch, ...]``.
    Stepwise (staleness-sim) mode: ``[num_workers, n_steps, batch, ...]``.
    """
    n = len(features)
    if n == 0:
        raise ValueError("empty dataset")
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    n_windows, total = plan_epoch(n, num_workers, batch_size, window)
    reps = -(-total // n)
    idx = np.tile(idx, reps)[:total]
    with telemetry.trace.span("epoch_arrays", phase="data", rows=int(total)):
        xs = np.ascontiguousarray(features)[idx]
        ys = np.ascontiguousarray(labels)[idx]
        if stepwise:
            shape = (num_workers, n_windows * window, batch_size)
        else:
            shape = (num_workers, n_windows, window, batch_size)
        xs = xs.reshape(shape + features.shape[1:])
        ys = ys.reshape(shape + labels.shape[1:])
    return xs, ys
