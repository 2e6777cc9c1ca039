"""Feature transformers — Spark-ML-style ``.transform(df)`` stages.

The port of :mod:`distkeras_tpu.transformers`, which is numpy over the
columnar frame and framework-neutral: copied, over the port's own
:mod:`distkeras_tpu_torch.frame`.  Reference parity:
``distkeras/transformers.py`` (``LabelIndexTransformer``,
``OneHotTransformer``, ``MinMaxTransformer``, ``ReshapeTransformer``,
``DenseTransformer``), each a per-row Python map over a Spark DataFrame;
here each is a vectorised numpy transform, same API and semantics.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from distkeras_tpu_torch.frame import DataFrame

__all__ = [
    "Transformer",
    "LabelIndexTransformer",
    "OneHotTransformer",
    "MinMaxTransformer",
    "ReshapeTransformer",
    "DenseTransformer",
    "StandardScaleTransformer",
]


class Transformer:
    """Base: a pure DataFrame -> DataFrame stage."""

    def transform(self, dataframe: DataFrame) -> DataFrame:
        raise NotImplementedError

    def __call__(self, dataframe: DataFrame) -> DataFrame:
        return self.transform(dataframe)


class LabelIndexTransformer(Transformer):
    """Probability/one-hot vector -> class index (reference parity:
    ``LabelIndexTransformer(output_dim, input_col, output_col)``)."""

    def __init__(self, output_dim: int, input_col: str = "prediction",
                 output_col: str = "prediction_index"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataframe: DataFrame) -> DataFrame:
        probs = dataframe.matrix(self.input_col)
        idx = np.argmax(probs.reshape(len(probs), -1), axis=-1).astype(np.int32)
        return dataframe.with_column(self.output_col, idx)


class OneHotTransformer(Transformer):
    """Class index -> one-hot vector (reference parity: ``OneHotTransformer``)."""

    def __init__(self, output_dim: int, input_col: str = "label",
                 output_col: str = "label_encoded"):
        self.output_dim = output_dim
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataframe: DataFrame) -> DataFrame:
        idx = np.asarray(dataframe.column(self.input_col), dtype=np.int64).reshape(-1)
        out = np.zeros((len(idx), self.output_dim), dtype=np.float32)
        out[np.arange(len(idx)), idx] = 1.0
        return dataframe.with_column(self.output_col, out)


class MinMaxTransformer(Transformer):
    """Rescale features to [o_min, o_max] (reference parity:
    ``MinMaxTransformer(n_min, n_max, o_min, o_max, input_col, output_col)``)."""

    def __init__(self, o_min: float = 0.0, o_max: float = 1.0,
                 n_min: float = 0.0, n_max: float = 255.0,
                 input_col: str = "features", output_col: str = "features_normalized"):
        self.o_min, self.o_max = float(o_min), float(o_max)
        self.n_min, self.n_max = float(n_min), float(n_max)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataframe: DataFrame) -> DataFrame:
        x = dataframe.matrix(self.input_col)
        scale = (self.o_max - self.o_min) / (self.n_max - self.n_min)
        out = (x - self.n_min) * scale + self.o_min
        return dataframe.with_column(self.output_col, out.astype(np.float32))


class ReshapeTransformer(Transformer):
    """Flat vector -> tensor shape (reference parity: ``ReshapeTransformer``,
    used to reshape 784-vectors into 28x28x1 images for CNNs)."""

    def __init__(self, input_col: str, output_col: str, shape: Sequence[int]):
        self.input_col = input_col
        self.output_col = output_col
        self.shape = tuple(int(s) for s in shape)

    def transform(self, dataframe: DataFrame) -> DataFrame:
        x = dataframe.matrix(self.input_col)
        return dataframe.with_column(self.output_col, x.reshape((len(x),) + self.shape))


class DenseTransformer(Transformer):
    """Sparse -> dense vectors (reference parity: ``DenseTransformer``).

    The columnar frame stores everything dense already; this densifies object
    columns (lists / scipy sparse rows) into a stacked float matrix.
    """

    def __init__(self, input_col: str = "features", output_col: str = "features_dense"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataframe: DataFrame) -> DataFrame:
        col = dataframe.column(self.input_col)
        if col.dtype == object:
            rows = []
            for v in col:
                if hasattr(v, "toarray"):  # scipy sparse
                    rows.append(np.asarray(v.toarray()).reshape(-1))
                else:
                    rows.append(np.asarray(v, dtype=np.float32).reshape(-1))
            dense = np.stack(rows).astype(np.float32)
        else:
            dense = np.asarray(col, dtype=np.float32)
        return dataframe.with_column(self.output_col, dense)


class StandardScaleTransformer(Transformer):
    """Zero-mean/unit-variance scaling (extension beyond the reference set)."""

    def __init__(self, input_col: str = "features", output_col: str = "features_standardized"):
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, dataframe: DataFrame) -> DataFrame:
        x = dataframe.matrix(self.input_col)
        mu = x.mean(axis=0, keepdims=True)
        sd = x.std(axis=0, keepdims=True) + 1e-8
        return dataframe.with_column(self.output_col, ((x - mu) / sd).astype(np.float32))
