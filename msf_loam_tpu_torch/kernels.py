"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, loaded
with ``ctypes``. Builds happen at first use (never at import: the CPU test
machine has no ``nvcc``), all sources in parallel, into ``_build/`` beside
this file (git-ignored). A library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale library never loads.

Every source is compiled with ``-fmad=false``: no multiply-add contraction,
so each float the kernels compare (distances, scores) is rounded exactly as
the plain PyTorch version rounds it.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("pick_rounds", "odo_corr", "select_fit", "knn", "block_tridiag")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    return "nvcc"


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:12]}.so")


def build_all() -> Dict[str, float]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all started together; load them all. Returns the wall seconds
    spent building (0.0 for a library already present). Raises if a build
    fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        if name in _LIBS:
            continue
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    seconds = time.perf_counter() - t0
    for name in SOURCES:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return {name: (seconds if name in procs else 0.0) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all kernels on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """One C function of a kernel library, its argument types and int
    return type set once, when it is first looked up."""
    fn = _FUNCS.get(symbol)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[symbol] = fn
    return fn


def stream(device: torch.device) -> int:
    """Raw handle of the current CUDA stream of ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` returns, without
    building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
