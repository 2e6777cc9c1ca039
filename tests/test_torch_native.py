"""Port parity: ``distkeras_tpu_torch.native`` (the C++ gather, the fused
bf16 gather and the SplitMix64 shuffle, built with ``g++`` at first use)
against ``distkeras_tpu.native`` on the same numpy inputs, bit for bit, and
the port's numpy fallback against both."""

import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu import native as jax_native
from distkeras_tpu_torch import native

torch.set_num_threads(1)  # the suite runs under xdist: keep each worker small


def _built():
    """The library must build wherever ``g++`` is on the PATH."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH: only the numpy fallback can run")
    assert native.available(), "g++ is on the PATH, yet the library did not build"


@pytest.fixture(params=["native", "fallback"])
def port(request, monkeypatch):
    """The port's module with its library (built with g++) or forced onto the
    numpy fallback."""
    if request.param == "fallback":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    else:
        _built()
    return native


def _bits(a):
    """bfloat16 values as their uint16 bits."""
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_gather_rows_matches_jax(port, dtype):
    rng = np.random.default_rng(0)
    src = (rng.normal(size=(300, 5, 3)) * 100).astype(dtype)
    idx = rng.integers(0, 300, size=700)
    got = port.gather_rows(src, idx)
    assert got.dtype == src.dtype
    np.testing.assert_array_equal(got, jax_native.gather_rows(src, idx))


def test_gather_rows_bf16_bits_match_jax(port):
    rng = np.random.default_rng(1)
    src = rng.normal(size=(64, 33)).astype(np.float32) * 1e3
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                         3.3895314e38, 1.0000001, 1.00390625, 1.01171875], np.float32)
    src[0, : len(specials)] = specials
    # ties: exactly halfway between two bfloat16 values, both parities
    src[1, :4] = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x7F7F8000],
                          np.uint32).view(np.float32)
    idx = rng.integers(0, 64, size=200)
    idx[:2] = [0, 1]
    got = port.gather_rows_bf16(src, idx)
    assert got.dtype == np.uint16 and got.shape == (200, 33)
    np.testing.assert_array_equal(got, _bits(jax_native.gather_rows_bf16(src, idx)))
    np.testing.assert_array_equal(got, _bits(src[idx].astype(ml_dtypes.bfloat16)))
    # read as bfloat16 with no second copy
    view = torch.from_numpy(got).view(torch.bfloat16)
    assert view.data_ptr() == got.ctypes.data


def test_gather_rows_bf16_from_float64_rounds_through_float32(port):
    src = np.random.default_rng(2).normal(size=(16, 4))
    idx = np.arange(16)[::-1]
    want = src[idx].astype(np.float32).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(port.gather_rows_bf16(src, idx), _bits(want))


def test_shuffle_indices_match_jax():
    _built()
    for seed in (0, 1, 42, 2**63 + 5):
        np.testing.assert_array_equal(native.shuffle_indices(1000, seed),
                                      jax_native.shuffle_indices(1000, seed))


def test_shuffle_fallback_is_the_numpy_shuffle(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    want = np.arange(100, dtype=np.int64)
    np.random.default_rng(7).shuffle(want)
    np.testing.assert_array_equal(native.shuffle_indices(100, 7), want)


def test_library_is_built_into_the_package_build_dir():
    _built()
    path = native._library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "distkeras_tpu_torch"
