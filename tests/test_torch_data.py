"""Port parity: ``distkeras_tpu_torch.data`` builds bitwise the same epoch
arrays as ``distkeras_tpu.data`` from the same numpy ``Generator``."""

import numpy as np
import pytest
import torch

from distkeras_tpu import data as jax_data
from distkeras_tpu_torch import data

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


@pytest.mark.parametrize("n,workers,batch,window", [(37, 2, 4, 3), (256, 4, 16, 2), (5, 1, 8, 1)])
def test_plan_epoch_matches_jax(n, workers, batch, window):
    assert data.plan_epoch(n, workers, batch, window) == jax_data.plan_epoch(n, workers, batch, window)


@pytest.mark.parametrize("stepwise", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_arrays_bitwise_equal_to_jax(stepwise, shuffle):
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 23, (37, 16)).astype(np.int32)
    labels = rng.standard_normal((37, 3)).astype(np.float32)
    ours = np.random.default_rng(7) if shuffle else None
    theirs = np.random.default_rng(7) if shuffle else None
    for _ in range(2):  # two epochs: the shuffle stream advances the same way
        xs, ys = data.epoch_arrays(feats, labels, 2, 4, 3, stepwise=stepwise, rng=ours)
        jxs, jys = jax_data.epoch_arrays(feats, labels, 2, 4, 3, stepwise=stepwise, rng=theirs)
        assert xs.dtype == jxs.dtype and ys.dtype == jys.dtype
        assert xs.shape == jxs.shape and np.array_equal(xs, jxs)
        assert ys.shape == jys.shape and np.array_equal(ys, jys)


def test_empty_dataset_raises():
    with pytest.raises(ValueError, match="empty"):
        data.epoch_arrays(np.zeros((0, 3)), np.zeros((0,)), 1, 4, 1)
