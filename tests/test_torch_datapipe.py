"""Port parity: ``distkeras_tpu_torch.data.epoch_window_iter`` and
``distkeras_tpu_torch.datapipe`` (sources, ``PrefetchRing``, ``DataState``)
against the JAX package on the same numpy inputs.  Blocks must be equal bit
for bit (bfloat16 blocks compared as their bits), and ``DataState`` must
serialise to the JAX package's dict."""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import data as jax_data
from distkeras_tpu import datapipe as jax_datapipe
from distkeras_tpu_torch import data, datapipe

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _arrays(n=203, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4, 3)).astype(np.float32) * 10,
            rng.integers(0, 5, size=n).astype(np.int32))


def _as_numpy(xs):
    """A port block's features as numpy: bfloat16 tensors as their bits."""
    if isinstance(xs, torch.Tensor):
        assert xs.dtype == torch.bfloat16
        return xs.view(torch.int16).numpy().view(np.uint16)
    return xs


def _jax_as_numpy(xs):
    return xs.view(np.uint16) if xs.dtype == ml_dtypes.bfloat16 else xs


@pytest.mark.parametrize("pad_to_window", [True, False])
@pytest.mark.parametrize("feature_dtype", [None, "bfloat16"])
def test_epoch_window_iter_matches_jax(pad_to_window, feature_dtype):
    feats, labels = _arrays()
    kw = dict(pad_to_window=pad_to_window)
    port = list(data.epoch_window_iter(feats, labels, 3, 4, 5, rng=np.random.default_rng(9),
                                       feature_dtype=feature_dtype and torch.bfloat16, **kw))
    want = list(jax_data.epoch_window_iter(feats, labels, 3, 4, 5, rng=np.random.default_rng(9),
                                           feature_dtype=feature_dtype and ml_dtypes.bfloat16,
                                           **kw))
    assert len(port) == len(want) > 1
    for (xs, ys), (jxs, jys) in zip(port, want):
        np.testing.assert_array_equal(_as_numpy(xs), _jax_as_numpy(jxs))
        np.testing.assert_array_equal(ys, jys)


def test_window_blocks_concatenate_to_epoch_arrays():
    feats, labels = _arrays()
    blocks = list(data.epoch_window_iter(feats, labels, 3, 4, 5, rng=np.random.default_rng(2)))
    xs, ys = data.epoch_arrays(feats, labels, 3, 4, 5, rng=np.random.default_rng(2))
    np.testing.assert_array_equal(np.stack([b[0] for b in blocks], axis=1), xs)
    np.testing.assert_array_equal(np.stack([b[1] for b in blocks], axis=1), ys)


def test_epoch_arrays_match_jax():
    feats, labels = _arrays()
    for stepwise in (False, True):
        got = data.epoch_arrays(feats, labels, 2, 8, 3, stepwise=stepwise,
                                rng=np.random.default_rng(4))
        want = jax_data.epoch_arrays(feats, labels, 2, 8, 3, stepwise=stepwise,
                                     rng=np.random.default_rng(4))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_start_block_yields_the_tail_and_draws_the_whole_shuffle():
    feats, labels = _arrays()
    full = list(data.epoch_window_iter(feats, labels, 2, 4, 3, rng=np.random.default_rng(5)))
    rng = np.random.default_rng(5)
    tail = list(data.epoch_window_iter(feats, labels, 2, 4, 3, rng=rng, start_block=3))
    assert len(tail) == len(full) - 3
    for (a, b), (c, d) in zip(tail, full[3:]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # the skipped blocks' shuffle was drawn all the same
    after = np.random.default_rng(5)
    after.shuffle(np.arange(len(feats)))
    assert rng.bit_generator.state == after.bit_generator.state
    with pytest.raises(ValueError, match="start_block"):
        next(data.epoch_window_iter(feats, labels, 2, 4, 3, start_block=99))


def test_sources_window_iter_match_jax(tmp_path):
    feats, labels = _arrays()
    np.save(tmp_path / "x.npy", feats)
    np.save(tmp_path / "y.npy", labels)
    pairs = [
        (datapipe.ArraySource(feats, labels, process_index=1, process_count=3),
         jax_datapipe.ArraySource(feats, labels, process_index=1, process_count=3)),
        (datapipe.MemmapSource(str(tmp_path / "x.npy"), str(tmp_path / "y.npy"),
                               process_index=2, process_count=3),
         jax_datapipe.MemmapSource(str(tmp_path / "x.npy"), str(tmp_path / "y.npy"),
                                   process_index=2, process_count=3)),
    ]
    for port, ref in pairs:
        assert len(port) == len(ref) == len(feats)
        assert port.local_rows == ref.local_rows
        got = list(port.window_iter(2, 4, 3, rng=np.random.default_rng(1)))
        want = list(ref.window_iter(2, 4, 3, rng=np.random.default_rng(1)))
        assert len(got) == len(want)
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_host_shard_and_atomic_write_match_jax(tmp_path):
    for n in (0, 1, 10, 203):
        for count in (1, 3, 4):
            for i in range(count):
                assert datapipe.host_shard(n, i, count) == jax_datapipe.host_shard(n, i, count)
    # one process without a torch.distributed group: everything
    assert datapipe.host_shard(11) == (0, 11)
    path = datapipe.atomic_write_npy(str(tmp_path / "a.npy"), np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(np.load(path), np.arange(6).reshape(2, 3))


def test_data_state_json_matches_jax():
    rng = np.random.default_rng(3)
    rng.random(7)
    port = datapipe.DataState.capture(4, rng, block_cursor=2)
    want = jax_datapipe.DataState.capture(4, rng, block_cursor=2)
    assert port.to_json() == want.to_json()
    back = datapipe.DataState.from_json(want.to_json())
    fresh = back.restore_rng(np.random.default_rng(0))
    assert fresh.random() == rng.random()
    assert datapipe.DataState(epoch=1).to_json() == jax_datapipe.DataState(epoch=1).to_json()


def test_prefetch_ring_keeps_the_order_and_puts_on_its_thread():
    seen_threads = []

    def put(block):
        seen_threads.append(threading.current_thread().name)
        return block * 10

    ring = datapipe.PrefetchRing(iter(range(20)), depth=3, put_fn=put)
    assert list(ring) == [i * 10 for i in range(20)]
    assert ring.blocks == 20 and ring.stall_seconds >= 0.0
    assert set(seen_threads) == {"datapipe-prefetch"}
    assert not ring._thread.is_alive()


def test_prefetch_ring_reraises_a_producer_fault():
    def source():
        yield 1
        yield 2
        raise KeyError("the source broke")

    ring = datapipe.PrefetchRing(source(), depth=2)
    assert next(ring) == 1 and next(ring) == 2
    with pytest.raises(KeyError, match="the source broke"):
        next(ring)
    assert not ring._thread.is_alive()


def test_prefetch_ring_close_mid_stream_joins_the_producer():
    ring = datapipe.PrefetchRing(iter(range(10**6)), depth=2)
    assert next(ring) == 0
    ring.close()
    assert not ring._thread.is_alive()
    with pytest.raises(StopIteration):
        next(ring)
    with datapipe.PrefetchRing(iter(range(5)), depth=1) as ctx:
        assert next(ctx) == 0
    assert not ctx._thread.is_alive()
