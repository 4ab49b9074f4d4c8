"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``_build/lib<name>.so`` (the build directory is git-ignored). A
library is built at its first ``load``; ``load`` called from several threads
builds several libraries side by side, one nvcc each. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "rows_scatter_add_tile", "hungarian_lap",
           "batch_norm_train")

_libs: Dict[str, ctypes.CDLL] = {}
_locks = {name: threading.Lock() for name in SOURCES}
build_logs: Dict[str, str] = {}  # nvcc's output (``-Xptxas -v``) of each library built here


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _paths(name: str):
    return CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def compile_source(src: Path, lib: Path) -> str:
    """nvcc of one CUDA source with a plain C interface into the shared
    library ``lib`` (sm_90a, ``-Xptxas -v``); returns nvcc's output."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return proc.stdout


def _compile(name: str) -> None:
    build_logs[name] = compile_source(*_paths(name))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if stale."""
    with _locks[name]:
        if name not in _libs:
            if _stale(name):
                _compile(name)
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]
