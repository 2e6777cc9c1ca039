"""Native (C++) data-path kernels, loaded with ctypes, with a numpy fallback.

The port of :mod:`distkeras_tpu.native`: ``dataloader.cpp`` is a copy of the
JAX package's source.  It is compiled with ``g++`` at first use (one
translation unit, about a second) into ``distkeras_tpu_torch/_build/``,
named by a hash of the source; without a toolchain every entry point falls
back to numpy, bit for bit.  ``DISTKERAS_TPU_NO_NATIVE`` forces the
fallback, as in the JAX package.

``gather_rows_bf16`` returns the bfloat16 bits as ``uint16`` (numpy has no
bfloat16); ``torch.from_numpy(bits).view(torch.bfloat16)`` reads them as
bfloat16 with no second copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "gather_rows", "gather_rows_bf16", "shuffle_indices"]

_SRC = Path(__file__).resolve().parent / "dataloader.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libdkdata_{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("DISTKERAS_TPU_NO_NATIVE"):
        return None
    path = _library_path()
    if not path.exists():
        try:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: concurrent first uses
            # (several test workers) never load a half-written library
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as td:
                tmp = os.path.join(td, "libdkdata.so")
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, str(_SRC), "-lpthread"],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(path))
        for name in ("dk_gather_rows", "dk_gather_rows_bf16"):
            getattr(lib, name).argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
        lib.dk_shuffle_indices.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_uint64,
        ]
        lib.dk_version.restype = ctypes.c_int
        if lib.dk_version() != 2:
            return None
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    """Whether the native library is built and loaded (else numpy runs)."""
    return _load() is not None


def _dispatch_gather(fn, src, idx, out, row_size, n_threads):
    """Shared ctypes marshalling for the gather entry points."""
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    fn(
        src.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_void_p),
        len(idx), row_size, n_threads,
    )
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: Optional[int] = None) -> np.ndarray:
    """``dst[i] = src[idx[i]]``: multithreaded native gather, numpy fallback."""
    lib = _load()
    src = np.ascontiguousarray(src)
    if lib is None:
        return src[idx]
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    row_bytes = int(np.prod(src.shape[1:], dtype=np.int64)) * src.dtype.itemsize
    return _dispatch_gather(lib.dk_gather_rows, src, idx, out, row_bytes, n_threads)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (``uint16``), round to nearest even, NaN
    quieted with its sign kept: the C++ ``f32_to_bf16`` in numpy."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, (u >> 16) | np.uint32(0x0040), rounded).astype(np.uint16)


def gather_rows_bf16(src: np.ndarray, idx: np.ndarray,
                     n_threads: Optional[int] = None) -> np.ndarray:
    """Fused ``bf16(src[idx])`` for float32 sources, as bfloat16 bits in a
    ``uint16`` array: one pass over the data instead of a gather, then a
    cast.  The native round-to-nearest-even matches ``ml_dtypes`` bit for
    bit; the fallback computes the same bits in numpy.  Other float sources
    gather, then round through float32."""
    src = np.ascontiguousarray(src)
    if src.dtype != np.float32:
        return _bf16_bits(gather_rows(src, idx, n_threads).astype(np.float32))
    lib = _load()
    if lib is None:
        return _bf16_bits(src[idx])
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.empty((len(idx),) + src.shape[1:], dtype=np.uint16)
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    return _dispatch_gather(lib.dk_gather_rows_bf16, src, idx, out, row_elems, n_threads)


def shuffle_indices(n: int, seed: int) -> np.ndarray:
    """Deterministic native Fisher-Yates permutation of ``arange(n)``
    (SplitMix64); the fallback shuffles with ``np.random.default_rng(seed)``,
    as the JAX package's does."""
    idx = np.arange(n, dtype=np.int64)
    lib = _load()
    if lib is None:
        np.random.default_rng(seed).shuffle(idx)
        return idx
    lib.dk_shuffle_indices(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, seed & (2**64 - 1)
    )
    return idx
