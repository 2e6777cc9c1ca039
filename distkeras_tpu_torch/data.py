"""Host-side batching: DataFrame columns -> epoch arrays or window blocks.

The port of :mod:`distkeras_tpu.data`.  The engine wants the whole epoch as
one array ``[num_workers, n_windows, window, batch, ...]`` (``epoch_arrays``),
or, streaming, one block ``[num_workers, window, batch, ...]`` at a time
(``epoch_window_iter``), built with wrap-around padding (no sample dropped)
and a per-epoch shuffle drawn from a numpy ``Generator``.  The same
generator gives bitwise the same arrays and blocks as the JAX package.  The
gather is the multithreaded native one (:mod:`distkeras_tpu_torch.native`,
bit-identical to numpy's ``features[idx]``, which it falls back to).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from distkeras_tpu_torch import native, telemetry

__all__ = ["epoch_arrays", "epoch_window_iter", "plan_epoch"]


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
        xs = native.gather_rows(features, idx)
        ys = native.gather_rows(labels, idx)
        if stepwise:
            shape = (num_workers, n_windows * window, batch_size)
        else:
            shape = (num_workers, n_windows, window, batch_size)
        xs = xs.reshape(shape + features.shape[1:])
        ys = ys.reshape(shape + labels.shape[1:])
    return xs, ys


def _is_bf16(dtype) -> bool:
    """Whether ``dtype`` (a torch dtype, a numpy dtype or a name) is bfloat16."""
    if dtype is None:
        return False
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return str(getattr(dtype, "name", dtype)).removeprefix("torch.") == "bfloat16"


def epoch_window_iter(
    features: np.ndarray,
    labels: np.ndarray,
    num_workers: int,
    batch_size: int,
    window: int,
    *,
    rng: Optional[np.random.Generator] = None,
    pad_to_window: bool = True,
    feature_dtype=None,
    start_block: int = 0,
):
    """Lazily yield one epoch as per-window blocks ``(xs, ys)`` shaped
    ``[num_workers, window, batch, ...]``: the streaming twin of
    :func:`epoch_arrays`.

    Draws the identical shuffle from ``rng`` and emits rows in exactly the
    order ``epoch_arrays`` lays them out, but gathers only
    ``num_workers * window * batch`` rows at a time, so the whole-epoch
    array never exists, on the host or the card.

    ``pad_to_window=True`` wrap-pads the step count up to a window multiple
    (commits need full windows; as ``epoch_arrays``).  With ``False`` the
    step count is planned at step granularity and the last block may be
    ragged: the shape for trainers that never commit.

    ``feature_dtype=bfloat16`` (with float features) gathers through the
    fused native gather and cast (``native.gather_rows_bf16``): one pass,
    half the bytes toward the card.  Those blocks' ``xs`` is a
    ``torch.bfloat16`` CPU tensor viewing the gather's ``uint16`` bits
    (numpy has no bfloat16); every other ``xs`` and ``ys`` is numpy.

    ``start_block=k`` skips the first ``k`` windows by index arithmetic (no
    gather is paid for them) while still drawing the full shuffle from
    ``rng``: restore the numpy bit state captured before the epoch's
    shuffle (:class:`~distkeras_tpu_torch.datapipe.DataState`) and the
    remaining blocks are bitwise the uninterrupted epoch's tail.
    """
    n = len(features)
    if n == 0:
        raise ValueError("empty dataset")
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    if pad_to_window:
        n_windows, total = plan_epoch(n, num_workers, batch_size, window)
        steps = n_windows * window
    else:
        steps, total = plan_epoch(n, num_workers, batch_size, 1)
        n_windows = -(-steps // window)
    reps = -(-total // n)
    idx = np.tile(idx, reps)[:total]
    # epoch_arrays reshapes worker-major: worker k / window w covers the flat
    # slice idx2[k, w*window:(w+1)*window] below.
    idx2 = idx.reshape(num_workers, steps, batch_size)
    fused_bf16 = _is_bf16(feature_dtype) and np.issubdtype(features.dtype, np.floating)
    start_block = int(start_block)
    if not 0 <= start_block <= n_windows:
        raise ValueError(
            f"start_block {start_block} outside this epoch's [0, {n_windows}] window range"
        )
    for w in range(start_block, n_windows):
        block = idx2[:, w * window : (w + 1) * window]
        cur = block.shape[1]  # < window only for a ragged final block
        sel = np.ascontiguousarray(block).ravel()
        block_shape = (num_workers, cur, batch_size)
        with telemetry.trace.span("window_gather", phase="data", window=w, rows=int(sel.size)):
            if fused_bf16:
                bits = native.gather_rows_bf16(features, sel)
                xs = torch.from_numpy(bits).view(torch.bfloat16)
                xs = xs.reshape(block_shape + features.shape[1:])
            else:
                xs = native.gather_rows(features, sel).reshape(block_shape + features.shape[1:])
            ys = native.gather_rows(labels, sel).reshape(block_shape + labels.shape[1:])
        yield xs, ys
