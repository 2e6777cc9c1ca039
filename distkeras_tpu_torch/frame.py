"""Columnar DataFrame shim — the replacement for Spark DataFrames.

A copy of :mod:`distkeras_tpu.frame` (numpy only), kept in the port so that
importing it never imports the JAX package.

The reference (``dist-keras``) keeps all user data in Spark ``DataFrame``s and
ships per-partition row iterators into executors (``distkeras/utils.py`` and
``DataFrame.rdd.mapPartitionsWithIndex`` call sites in
``distkeras/trainers.py``).  Here there is no Spark: the natural layout is a
*columnar* batch of host numpy arrays that can be batched straight onto a
device.  This module provides a small DataFrame with the subset of
the Spark API the reference's transformers / predictors / evaluators and
example notebooks rely on (``select``, ``withColumn``, ``repartition``,
``collect``, ``count``, ``filter``, ``sample``, ...), backed by a dict of
numpy arrays instead of an RDD.

Unlike Spark rows, columns are whole numpy arrays, so feature transforms are
vectorised (orders of magnitude faster than the reference's per-row Python
loops) and handing data to torch is a zero-copy ``torch.from_numpy``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Sequence, Union

import numpy as np

__all__ = [
    "DataFrame", "Row", "from_rows", "from_numpy", "from_pandas",
    "from_spark", "to_spark", "read_csv",
]


class Row(dict):
    """Dict-like row with attribute access, mirroring ``pyspark.sql.Row``."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - defensive
            raise AttributeError(name) from e

    def asDict(self) -> dict:
        return dict(self)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
        return f"Row({inner})"


def _as_column(values, length_hint: int | None = None) -> np.ndarray:
    """Coerce a column to a numpy array; ragged data falls back to object dtype."""
    if isinstance(values, np.ndarray):
        return values
    values = list(values)
    try:
        arr = np.asarray(values)
        if arr.dtype == object and values and isinstance(values[0], (list, np.ndarray)):
            raise ValueError("ragged")
        return arr
    except ValueError:
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = np.asarray(v)
        return arr


class DataFrame:
    """Immutable columnar frame: a dict of equal-length numpy columns.

    ``num_partitions`` is carried as metadata (the analogue of Spark
    partitioning): trainers use it to decide how many workers see the data,
    and ``partitions()`` yields contiguous row-range shards.
    """

    def __init__(self, columns: Mapping[str, np.ndarray], num_partitions: int = 1):
        cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column {name!r} has length {len(arr)}, expected {n}"
                )
            cols[name] = arr
        self._columns = cols
        self._n = 0 if n is None else int(n)
        self.num_partitions = max(1, int(num_partitions))

    # -- schema ------------------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __len__(self) -> int:
        return self._n

    def count(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def column(self, name: str) -> np.ndarray:
        """The raw numpy column."""
        return self._columns[name]

    def matrix(self, name: str, dtype=np.float32) -> np.ndarray:
        """Column as a dense stacked ndarray [n, ...] (object columns stacked)."""
        col = self._columns[name]
        if col.dtype == object:
            col = np.stack([np.asarray(v) for v in col])
        return np.asarray(col, dtype=dtype)

    # -- transforms (all return new frames) --------------------------------
    def select(self, *names: str) -> "DataFrame":
        return DataFrame({n: self._columns[n] for n in names}, self.num_partitions)

    def with_column(self, name: str, values) -> "DataFrame":
        cols = dict(self._columns)
        cols[name] = _as_column(values)
        return DataFrame(cols, self.num_partitions)

    # Spark-style alias used by the reference notebooks.
    withColumn = with_column

    def drop(self, *names: str) -> "DataFrame":
        return DataFrame(
            {n: c for n, c in self._columns.items() if n not in names},
            self.num_partitions,
        )

    def rename(self, old: str, new: str) -> "DataFrame":
        cols = {(new if n == old else n): c for n, c in self._columns.items()}
        return DataFrame(cols, self.num_partitions)

    withColumnRenamed = rename

    def filter(self, predicate: Union[np.ndarray, Callable[[Row], bool]]) -> "DataFrame":
        if callable(predicate):
            mask = np.fromiter(
                (bool(predicate(r)) for r in self.iter_rows()), dtype=bool, count=self._n
            )
        else:
            mask = np.asarray(predicate, dtype=bool)
        return DataFrame(
            {n: c[mask] for n, c in self._columns.items()}, self.num_partitions
        )

    where = filter

    def sample(self, fraction: float, seed: int | None = None) -> "DataFrame":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n) < fraction
        return self.filter(mask)

    def shuffle(self, seed: int | None = None) -> "DataFrame":
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._n)
        return DataFrame(
            {n: c[perm] for n, c in self._columns.items()}, self.num_partitions
        )

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(
            {name: c[:n] for name, c in self._columns.items()}, self.num_partitions
        )

    def union(self, other: "DataFrame") -> "DataFrame":
        if set(self.columns) != set(other.columns):
            raise ValueError("union requires identical column sets")
        return DataFrame(
            {n: np.concatenate([self._columns[n], other._columns[n]]) for n in self.columns},
            self.num_partitions,
        )

    def split(self, fraction: float, seed: int | None = None):
        """Random (train, test) split — the notebooks' randomSplit equivalent."""
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n) < fraction
        return self.filter(mask), self.filter(~mask)

    def randomSplit(self, weights: Sequence[float], seed: int | None = None):
        rng = np.random.default_rng(seed)
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        assignment = rng.choice(len(w), size=self._n, p=w)
        return [self.filter(assignment == i) for i in range(len(w))]

    # -- partitioning ------------------------------------------------------
    def repartition(self, n: int) -> "DataFrame":
        return DataFrame(self._columns, num_partitions=n)

    def coalesce(self, n: int) -> "DataFrame":
        return DataFrame(self._columns, num_partitions=min(n, self.num_partitions))

    def partitions(self) -> Iterator["DataFrame"]:
        """Contiguous row-range shards, one per partition."""
        bounds = np.linspace(0, self._n, self.num_partitions + 1).astype(int)
        for i in range(self.num_partitions):
            lo, hi = bounds[i], bounds[i + 1]
            yield DataFrame({n: c[lo:hi] for n, c in self._columns.items()}, 1)

    # -- materialisation ---------------------------------------------------
    def iter_rows(self) -> Iterator[Row]:
        names = self.columns
        cols = [self._columns[n] for n in names]
        for i in range(self._n):
            yield Row({n: c[i] for n, c in zip(names, cols)})

    def collect(self) -> List[Row]:
        return list(self.iter_rows())

    def take(self, n: int) -> List[Row]:
        return self.limit(n).collect()

    def first(self) -> Row:
        return self.take(1)[0]

    def cache(self) -> "DataFrame":  # Spark-compat no-op
        return self

    persist = cache

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: list(c) for n, c in self._columns.items()})

    toPandas = to_pandas

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DataFrame[{self._n} rows x {len(self._columns)} cols, "
            f"{self.num_partitions} partitions: {self.columns}]"
        )


# -- constructors ----------------------------------------------------------

def from_rows(rows: Iterable[Mapping], num_partitions: int = 1) -> DataFrame:
    rows = list(rows)
    if not rows:
        return DataFrame({}, num_partitions)
    names = list(rows[0].keys())
    return DataFrame(
        {n: _as_column([r[n] for r in rows]) for n in names}, num_partitions
    )


def from_numpy(
    features: np.ndarray,
    labels: np.ndarray | None = None,
    features_col: str = "features",
    label_col: str = "label",
    num_partitions: int = 1,
) -> DataFrame:
    cols = {features_col: np.asarray(features)}
    if labels is not None:
        cols[label_col] = np.asarray(labels)
    return DataFrame(cols, num_partitions)


def from_pandas(pdf, num_partitions: int = 1) -> DataFrame:
    return DataFrame({c: _as_column(pdf[c].to_list()) for c in pdf.columns}, num_partitions)


def from_spark(sdf, columns: Sequence[str] | None = None) -> DataFrame:
    """Bridge a **pyspark** DataFrame into the columnar frame.

    The reference lived natively on Spark DataFrames; users migrating actual
    Spark pipelines call this once at the boundary
    (``dk.from_spark(spark_df)``) and keep the rest of the flow unchanged.
    Spark ML vector values (``DenseVector``/``SparseVector`` — the
    features/label columns the reference's transformers produce) are
    densified via their ``toArray``.  Prefers ``toPandas()`` (Arrow fast
    path) and falls back to ``collect()``; partitioning metadata carries
    over from ``rdd.getNumPartitions()`` when available.

    pyspark itself is NOT a dependency: this function only touches the
    object it's handed.
    """
    names = list(columns) if columns is not None else list(sdf.columns)

    def densify(v):
        return np.asarray(v.toArray(), np.float32) if hasattr(v, "toArray") else v

    try:
        pdf = sdf.toPandas()  # ONLY the transfer is fallible-by-design
    except Exception:
        pdf = None
    if pdf is not None:
        data = {c: [densify(v) for v in pdf[c].to_list()] for c in names}
    else:
        rows = sdf.collect()
        data = {c: [densify(r[c]) for r in rows] for c in names}
    try:
        num_partitions = int(sdf.rdd.getNumPartitions())
    except Exception:
        num_partitions = 1
    return DataFrame({c: _as_column(v) for c, v in data.items()}, num_partitions)


def to_spark(df: DataFrame, spark, columns: Sequence[str] | None = None):
    """Write the columnar frame back out as a **pyspark** DataFrame — the
    egress half of the Spark boundary (``from_spark`` is the ingress half).

    The reference's whole flow lived inside Spark DataFrames, so a pipeline
    could end with ``predictor.predict(df)`` feeding downstream Spark ML
    (SURVEY.md §2 Predictors row); migrating users close the loop with
    ``dk.to_spark(frame, spark)`` after training/inference here.

    Vector-valued columns (multi-dim or object rows — features, predictions)
    become per-row Python float lists, which Spark infers as ``array<double>``;
    scalar columns pass through.  Hands ``spark.createDataFrame`` a pandas
    frame when pandas imports (Arrow fast path, mirroring ``from_spark``'s
    ``toPandas`` preference), else a list of plain dict rows.

    pyspark itself is NOT a dependency: this function only calls
    ``createDataFrame`` on the SparkSession it is handed.
    """
    names = list(columns) if columns is not None else df.columns

    def numeric_row(v) -> bool:
        arr = np.asarray(v)
        if arr.dtype != object:
            return np.issubdtype(arr.dtype, np.number) or arr.dtype == bool
        # object-dtype rows (how _as_column stores ragged vectors): look at
        # the scalar leaves themselves
        import numbers

        return all(isinstance(x, numbers.Number) for x in arr.ravel())

    def pyify(name):
        col = df.column(name)
        if col.dtype == object or col.ndim > 1:
            # Decide numeric-vs-not by inspecting element dtypes, not by
            # attempting the cast and catching: exception-driven dispatch
            # would coerce numeric-LOOKING strings ("1.5") to floats, and
            # one stray string deep in an otherwise-numeric column would
            # flip every row to the scalar branch mid-stream.
            if all(numeric_row(v) for v in col):
                return [np.asarray(v).ravel().astype(float).tolist()
                        for v in col]
            # non-numeric object column (strings, ids — ubiquitous in
            # Spark frames): pass the rows through as Python scalars
            # like the scalar branch does, don't force-cast to float
            return [v.item() if isinstance(v, np.generic) else v
                    for v in col]
        return col.tolist()

    data = {name: pyify(name) for name in names}
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        return spark.createDataFrame(pd.DataFrame(data))
    rows = [{name: data[name][i] for name in names} for i in range(len(df))]
    return spark.createDataFrame(rows)


def read_csv(path: str, header: bool = True, num_partitions: int = 1) -> DataFrame:
    """Minimal CSV reader (numeric columns become float arrays)."""
    import csv

    with open(path, newline="") as f:
        reader = csv.reader(f)
        rows = list(reader)
    if not rows:
        return DataFrame({}, num_partitions)
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = [f"_c{i}" for i in range(len(rows[0]))]
    cols = {}
    for i, name in enumerate(names):
        raw = [r[i] for r in rows]
        try:
            cols[name] = np.asarray(raw, dtype=np.float64)
        except ValueError:
            cols[name] = np.asarray(raw, dtype=object)
    return DataFrame(cols, num_partitions)
