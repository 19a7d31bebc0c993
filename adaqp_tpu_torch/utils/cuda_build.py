"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``adaqp_tpu_torch/csrc/<name>.cu`` holds kernels behind a plain
``extern "C"`` launcher (no PyTorch headers, so a build takes seconds).
It compiles into ``build/kernels/lib<name>.so`` at the checkout's root on
first use, for Hopper only (``sm_90a``), and rebuilds when the source or a
shared header (``csrc/*.cuh``) is newer than the library. Nothing here
runs at import time: the CPU tests import every module of the package on
machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "build", "kernels"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` under ``$CUDA_HOME`` (default ``/usr/local/cuda``) or on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed"
        )
    return found


def _paths(name: str):
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return os.path.normpath(src), os.path.normpath(lib)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile each named source, all ``nvcc`` processes started together.

    Returns each build's compiler log (``-Xptxas -v``: registers, shared
    memory and spills per kernel); raises with the log if any build fails.
    """
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, lib,
        )
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first when missing or stale."""
    if name in _LIBS:
        return _LIBS[name]
    src, lib = _paths(name)
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    newest = max(os.path.getmtime(p) for p in [src, *headers])
    if not os.path.exists(lib) or os.path.getmtime(lib) < newest:
        build([name])
    _LIBS[name] = ctypes.CDLL(lib)
    return _LIBS[name]
