"""Build and bind the port's CUDA kernels.

Each kernel source in ``distkeras_tpu_torch/csrc`` has a plain C interface.
At first use it is compiled with ``nvcc`` into a shared library under
``distkeras_tpu_torch/_build/`` (a directory git ignores), named by a hash
of the source, the headers beside it and the compiler flags, and loaded
with ``ctypes``.  ptxas's report of each kernel's registers and spills is
kept beside the library (``<library>.ptxas.txt``).  Nothing
is built or loaded when a module is imported: the CPU-only test runs import
every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = [
    "NVCC_FLAGS",
    "build",
    "build_all",
    "flash_attention_bwd_library",
    "flash_attention_fwd_library",
    "nvcc_path",
    "ptxas_log",
]

_PACKAGE = Path(__file__).resolve().parent.parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def source_digest(source: Path) -> str:
    """Hash of what a build of ``source`` reads: the compiler flags, the
    source and every header (``*.cuh``) in its directory, so that editing a
    shared header never loads a library built from the old one."""
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for path in (source, *sorted(source.parent.glob("*.cuh"))):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str, source: Path) -> Path:
    """Compile ``source`` into ``_build/<name>-<hash>.so`` unless that file
    already exists; returns its path.  The library is written under a
    temporary name and renamed, so concurrent builds never load a partial
    file."""
    out = BUILD_DIR / f"{name}-{source_digest(source)}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode} building {source.name}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    ptxas_log(out).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_log(library: Path) -> Path:
    """Where :func:`build` keeps the compiler's ``-Xptxas=-v`` report."""
    return library.with_suffix(".ptxas.txt")


@functools.cache
def flash_attention_fwd_library() -> ctypes.CDLL:
    """The flash-attention forward kernel, built and bound (once per process)."""
    lib = ctypes.CDLL(str(build("flash_attention_fwd", CSRC / "flash_attention_fwd.cu")))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dk_flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr,          # q, k, v, o, lse
        i32, i32, i32, i32, i32,          # batch, heads, lq, lk, head_dim
        i64, i64, i64,                    # q strides: batch, seq, head
        i64, i64, i64,                    # k strides
        i64, i64, i64,                    # v strides
        i32, i32, ctypes.c_float, ptr,    # causal, dtype code, scale, stream
    ]
    lib.dk_flash_attention_fwd.restype = i32
    lib.dk_cuda_error_string.argtypes = [i32]
    lib.dk_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def flash_attention_bwd_library() -> ctypes.CDLL:
    """The flash-attention backward kernels (dQ and dK/dV), built and bound
    (once per process)."""
    lib = ctypes.CDLL(str(build("flash_attention_bwd", CSRC / "flash_attention_bwd.cu")))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    strides = [i64] * 12                  # q, k, v, dO strides: batch, seq, head
    tail = [i32, i32, ctypes.c_float, ptr]  # causal, dtype code, scale, stream
    shape = [i32] * 5                     # batch, heads, lq, lk, head_dim
    lib.dk_flash_attention_bwd_dq.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,     # q, k, v, dO, lse, delta
        ptr,                              # dq
        *shape, *strides, *tail,
    ]
    lib.dk_flash_attention_bwd_dkv.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,     # q, k, v, dO, lse, delta
        ptr, ptr,                         # dk, dv
        *shape, *strides, *tail,
    ]
    lib.dk_flash_attention_bwd_dq.restype = i32
    lib.dk_flash_attention_bwd_dkv.restype = i32
    lib.dk_cuda_error_string.argtypes = [i32]
    lib.dk_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> None:
    """Build every kernel library at once, one ``nvcc`` per source running
    side by side (each build is a separate process)."""
    from concurrent.futures import ThreadPoolExecutor

    loaders = (flash_attention_fwd_library, flash_attention_bwd_library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for future in [pool.submit(load) for load in loaders]:
            future.result()
