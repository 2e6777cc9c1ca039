"""Utilities: reference-parity helpers (``distkeras/utils.py``) and tree
arithmetic over name -> tensor dicts — the port of
:mod:`distkeras_tpu.utils`.

The reference's ``utils.py`` carries model (de)serialization, DataFrame row
helpers, shuffling, and dense-vector conversion.  The same surface lives
here over the port's columnar :mod:`distkeras_tpu_torch.frame` DataFrame and
its parameter dicts.  The JAX package's ``utils/compat.py`` (a
``shard_map`` shim across JAX versions) has no PyTorch counterpart.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.frame import DataFrame, Row
from distkeras_tpu_torch.utils.pytree import (
    tree_add,
    tree_add_scaled,
    tree_cast,
    tree_global_norm,
    tree_leaves,
    tree_map,
    tree_ones_like,
    tree_scale,
    tree_size,
    tree_sub,
    tree_where,
    tree_zeros_like,
)
from distkeras_tpu_torch.utils.serialization import (
    deserialize_keras_model,
    params_from_bytes,
    params_to_bytes,
    serialize_keras_model,
    uniform_weights,
)

__all__ = [
    "shuffle",
    "new_dataframe_row",
    "to_dense_vector",
    "serialize_keras_model",
    "deserialize_keras_model",
    "uniform_weights",
    "params_to_bytes",
    "params_from_bytes",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_add_scaled",
    "tree_zeros_like",
    "tree_ones_like",
    "tree_global_norm",
    "tree_size",
    "tree_cast",
    "tree_where",
    "tree_leaves",
    "tree_map",
]


def shuffle(df: DataFrame, seed: int | None = None) -> DataFrame:
    """Random row permutation (reference parity: ``distkeras/utils.py :: shuffle``)."""
    return df.shuffle(seed)


def new_dataframe_row(row: Row, name: str, value) -> Row:
    """Copy a row with one extra column (reference parity:
    ``distkeras/utils.py :: new_dataframe_row``)."""
    out = Row(row)
    out[name] = value
    return out


def to_dense_vector(value, size: int) -> np.ndarray:
    """Class index -> one-hot dense vector (reference parity:
    ``distkeras/utils.py`` dense-vector conversion used by the MNIST example).

    Accepts a scalar class index (one-hot encode) or an already-dense vector
    (pass through, padded/truncated to ``size``).
    """
    arr = np.asarray(value)
    if arr.ndim == 0:
        out = np.zeros(size, dtype=np.float32)
        out[int(arr)] = 1.0
        return out
    out = np.zeros(size, dtype=np.float32)
    n = min(size, arr.shape[0])
    out[:n] = arr[:n]
    return out
