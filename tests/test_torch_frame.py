"""Port parity: the port's copy of the columnar DataFrame behaves as the JAX
package's ``distkeras_tpu.frame`` on the same numpy data."""

import numpy as np
import pytest
import torch

from distkeras_tpu import frame as jax_frame
from distkeras_tpu_torch import frame as port_frame

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _build(mod):
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((12, 3)).astype(np.float32)
    labels = rng.integers(0, 2, 12)
    return mod.from_numpy(feats, labels, num_partitions=3)


OPS = {
    "select": lambda df: [df.select("label")],
    "with_column": lambda df: [df.with_column("x2", df["label"] * 2)],
    "filter_mask": lambda df: [df.filter(df["label"] == 1)],
    "filter_row": lambda df: [df.filter(lambda r: r.features[0] > 0)],
    "sample": lambda df: [df.sample(0.5, seed=3)],
    "shuffle": lambda df: [df.shuffle(seed=4)],
    "split": lambda df: list(df.split(0.6, seed=5)),
    "random_split": lambda df: df.randomSplit([1, 2, 1], seed=6),
    "partitions": lambda df: list(df.partitions()),
    "union_limit": lambda df: [df.union(df).limit(17)],
    "rename_drop": lambda df: [df.rename("label", "y").drop("features")],
}


def _assert_same(a, b):
    assert a.columns == b.columns and len(a) == len(b)
    assert a.num_partitions == b.num_partitions
    for name in a.columns:
        np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("op", sorted(OPS))
def test_frame_ops_match_jax(op):
    got, ref = OPS[op](_build(port_frame)), OPS[op](_build(jax_frame))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _assert_same(a, b)


def test_rows_and_csv_match_jax(tmp_path):
    rows = [{"a": 1.0, "b": "x"}, {"a": 2.5, "b": "y"}]
    _assert_same(port_frame.from_rows(rows), jax_frame.from_rows(rows))
    assert port_frame.from_rows(rows).collect()[1].b == "y"
    path = tmp_path / "t.csv"
    path.write_text("a,b,c\n1,2,p\n3,4.5,q\n")
    _assert_same(port_frame.read_csv(str(path)), jax_frame.read_csv(str(path)))
    ragged = [np.arange(2), np.arange(3)]
    got = port_frame.DataFrame({"r": ragged})
    assert got["r"].dtype == object
    np.testing.assert_array_equal(got["r"][1], jax_frame.DataFrame({"r": ragged})["r"][1])
