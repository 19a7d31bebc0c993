"""ctypes loader for the native preprocessing library (``adaqp_native.cc``
beside this file): CSR construction and LDG partitioning.

The library compiles with ``g++`` on first use into ``build/native/`` at
the checkout's root (git-ignored), and again when the source is newer
than the library; nothing builds at import time. A failed build raises
``NativeUnavailable`` with the compiler's message: the caller
(``graph/partition.py``) logs it and runs the numpy path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "adaqp_native.cc")
BUILD_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build", "native"))
LIB = os.path.join(BUILD_DIR, "libadaqp_native.so")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None


class NativeUnavailable(RuntimeError):
    """The library could not be built or loaded."""


def _build() -> None:
    """Compile into a temporary file and rename it over the library, so
    that a process loading the library never reads a half-written one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as exc:  # no compiler
        os.unlink(tmp)
        raise NativeUnavailable(f"g++ did not start: {exc}") from exc
    if proc.returncode:
        os.unlink(tmp)
        raise NativeUnavailable(f"g++ failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB)


def load() -> ctypes.CDLL:
    """The loaded library, built first when missing or older than its source."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(LIB) or os.path.getmtime(LIB) < os.path.getmtime(SRC):
        _build()
    try:
        lib = ctypes.CDLL(LIB)
    except OSError as exc:
        raise NativeUnavailable(f"loading {LIB} failed: {exc}") from exc
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.build_csr.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p, i64p, i32p]
    lib.build_csr.restype = None
    lib.bfs_order.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
    lib.bfs_order.restype = None
    lib.ldg_partition.argtypes = [
        ctypes.c_int64, i64p, i32p, i64p, ctypes.c_int32, ctypes.c_double, i32p,
    ]
    lib.ldg_partition.restype = None
    _lib = lib
    return lib


def _check_ids(src: np.ndarray, dst: np.ndarray, n: int) -> None:
    # the library indexes with these ids unchecked
    if len(src) != len(dst):
        raise ValueError(f"{len(src)} sources for {len(dst)} destinations")
    if len(src) and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= n):
        raise ValueError(f"node ids outside [0, {n})")


def build_csr(src: np.ndarray, dst: np.ndarray, n: int):
    """``(indptr int64 [n+1], indices int32 [e])``: the edges grouped by
    source, each group in edge order."""
    _check_ids(src, dst, n)
    lib = load()
    indptr = np.zeros(n + 1, np.int64)
    indices = np.zeros(len(src), np.int32)
    lib.build_csr(n, len(src), np.ascontiguousarray(src, np.int32),
                  np.ascontiguousarray(dst, np.int32), indptr, indices)
    return indptr, indices


def ldg_partition(src: np.ndarray, dst: np.ndarray, n: int, k: int, slack: float = 1.05):
    """LDG streaming partitioning in BFS order: int32 part id [n]."""
    indptr, indices = build_csr(src, dst, n)
    lib = load()
    order = np.zeros(n, np.int64)
    lib.bfs_order(n, indptr, indices, order)
    part = np.zeros(n, np.int32)
    lib.ldg_partition(n, indptr, indices, order, k, slack, part)
    return part
