"""Sources — where training rows live, sharded per host.

The port of :mod:`distkeras_tpu.datapipe.source`.  The reference reads Spark
DataFrame partitions on the executors (SURVEY.md §3.1); across several
processes the analogue is each process gathering only its slice of the
dataset.  A
``Source`` owns (a) the global row count and (b) this host's local feature /
label arrays; ``window_iter`` then streams the local slice through the exact
``epoch_window_iter`` layout, so everything downstream (PrefetchRing,
``run_epoch_streaming``) is source-agnostic.

Two concrete sources:

* :class:`ArraySource` — in-memory numpy arrays or DataFrame columns
  (``from_dataframe`` applies the same dtype rules as the trainers).
* :class:`MemmapSource` — ``.npy`` files opened with ``mmap_mode="r"``:
  a single file shards by row range (zero-copy view), a list of file shards
  shards round-robin by file.  Pages fault in as the gather touches them,
  so datasets larger than host RAM stream without a load step.

Sharding is keyed on the ``torch.distributed`` rank and world size when a
process group is up, else one process (overridable for tests and tooling).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["Source", "ArraySource", "MemmapSource", "atomic_write_npy",
           "host_shard"]


def _fsync_dir(path: str) -> None:
    """Make a directory entry durable (the rename itself, not just the
    renamed bytes).  Best-effort: not every filesystem lets you open or
    fsync a directory."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_npy(path: str, array: np.ndarray) -> str:
    """Publish one ``.npy`` shard atomically: tmp + fsync + ``os.replace`` +
    parent-dir fsync, the same discipline as checkpoint manifests.
    A cross-process reader — a :class:`MemmapSource` built by a window
    scheduler polling the shard directory — sees the old file or the new
    file, never a torn header or a half-written row, and the new bytes
    survive power loss once this returns.  Returns ``path``."""
    array = np.ascontiguousarray(array)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, array)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path


def _process_slot(process_index: Optional[int], process_count: Optional[int]):
    if process_count is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    return int(process_index or 0), int(process_count)


def host_shard(n: int, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> Tuple[int, int]:
    """Contiguous ``[lo, hi)`` row range owned by this host: balanced to
    within one row, every row owned by exactly one host."""
    idx, count = _process_slot(process_index, process_count)
    if not 0 <= idx < count:
        raise ValueError(f"process_index {idx} outside [0, {count})")
    base, rem = divmod(int(n), count)
    lo = idx * base + min(idx, rem)
    hi = lo + base + (1 if idx < rem else 0)
    return lo, hi


class Source:
    """A sharded dataset: global length + this host's local arrays.

    Subclasses set ``_features`` / ``_labels`` (the LOCAL slice) and
    ``_global_rows``; ``window_iter`` streams the local slice in the
    bitwise ``epoch_window_iter`` layout.
    """

    _features: np.ndarray
    _labels: np.ndarray
    _global_rows: int

    def __len__(self) -> int:
        """Global row count across all hosts."""
        return self._global_rows

    @property
    def local_rows(self) -> int:
        return len(self._features)

    def local_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(features, labels) for this host only."""
        return self._features, self._labels

    def window_iter(self, num_workers: int, batch_size: int, window: int, *,
                    rng: Optional[np.random.Generator] = None,
                    pad_to_window: bool = True, feature_dtype=None,
                    start_block: int = 0):
        """This host's epoch as per-window blocks — exactly
        :func:`distkeras_tpu_torch.data.epoch_window_iter` over ``local_arrays()``
        (same shuffle draw, same row order, same fused bf16 gather), so a
        Source drops into ``run_epoch_streaming`` / ``PrefetchRing``
        unchanged."""
        from distkeras_tpu_torch.data import epoch_window_iter

        feats, labels = self.local_arrays()
        return epoch_window_iter(
            feats, labels, num_workers, batch_size, window,
            rng=rng, pad_to_window=pad_to_window,
            feature_dtype=feature_dtype, start_block=start_block,
        )


class ArraySource(Source):
    """In-memory rows, sliced per host.

    ``shard=False`` keeps the full arrays (single-host training, or data
    already sharded upstream); the slice is a view, never a copy.
    """

    def __init__(self, features, labels, *, shard: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        features = np.asarray(features)
        labels = np.asarray(labels)
        if len(features) != len(labels):
            raise ValueError(
                f"features ({len(features)} rows) and labels "
                f"({len(labels)} rows) disagree"
            )
        self._global_rows = len(features)
        if shard:
            lo, hi = host_shard(len(features), process_index, process_count)
            features, labels = features[lo:hi], labels[lo:hi]
        self._features, self._labels = features, labels

    @classmethod
    def from_dataframe(cls, dataframe, features_col: str = "features",
                       label_col: str = "label", **kwargs) -> "ArraySource":
        """Materialise DataFrame columns with the trainers' dtype rules
        (integer token features stay int32; everything else float32)."""
        f_raw = dataframe.column(features_col)
        if f_raw.dtype != object and np.issubdtype(f_raw.dtype, np.integer):
            feats = f_raw.astype(np.int32)
        else:
            feats = dataframe.matrix(features_col, dtype=np.float32)
        labels_raw = dataframe.column(label_col)
        if labels_raw.dtype == object:
            labels = dataframe.matrix(label_col, dtype=np.float32)
        elif np.issubdtype(labels_raw.dtype, np.integer):
            labels = labels_raw.astype(np.int32)
        else:
            labels = labels_raw.astype(np.float32)
        return cls(feats, labels, **kwargs)


class MemmapSource(Source):
    """Memory-mapped ``.npy`` rows, sharded per host.

    One file each: the host takes its row range as a zero-copy mmap view
    (the native gather reads straight out of the page cache).  A sequence
    of file shards: shards are assigned round-robin by
    ``paths[process_index::process_count]`` and a host's multiple shards
    concatenate on first access (a copy of the LOCAL slice only — prefer
    >= one shard per host to stay zero-copy).
    """

    def __init__(self, feature_paths, label_paths, *, shard: bool = True,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        f_paths = self._as_paths(feature_paths)
        l_paths = self._as_paths(label_paths)
        if len(f_paths) != len(l_paths):
            raise ValueError(
                f"{len(f_paths)} feature shard(s) vs {len(l_paths)} label "
                "shard(s) — they must pair up"
            )
        f_maps = [np.load(p, mmap_mode="r") for p in f_paths]
        l_maps = [np.load(p, mmap_mode="r") for p in l_paths]
        for fp, fm, lm in zip(f_paths, f_maps, l_maps):
            if len(fm) != len(lm):
                raise ValueError(
                    f"shard {fp}: {len(fm)} feature rows vs {len(lm)} labels"
                )
        self._global_rows = sum(len(m) for m in f_maps)
        idx, count = _process_slot(process_index, process_count)
        if not shard:
            idx, count = 0, 1
        if len(f_maps) == 1:
            # single file: row-range sharding, zero-copy mmap views
            lo, hi = host_shard(self._global_rows, idx, count)
            self._features = f_maps[0][lo:hi]
            self._labels = l_maps[0][lo:hi]
        else:
            mine_f = f_maps[idx::count]
            mine_l = l_maps[idx::count]
            if not mine_f:
                raise ValueError(
                    f"host {idx}/{count} got zero of {len(f_maps)} file "
                    "shards — provide at least one shard per host"
                )
            if len(mine_f) == 1:
                self._features, self._labels = mine_f[0], mine_l[0]
            else:
                self._features = np.concatenate([np.asarray(m) for m in mine_f])
                self._labels = np.concatenate([np.asarray(m) for m in mine_l])

    @staticmethod
    def _as_paths(paths) -> Sequence[str]:
        if isinstance(paths, (str, bytes)):
            return [paths]
        out = list(paths)
        if not out:
            raise ValueError("empty shard list")
        return out
