"""ctypes bindings for the port's native host runtime (``loader.cc``).

The port's copy of the JAX package's ``runtime/``. ``g++`` builds
``libmsf_runtime_<hash>.so`` into ``msf_loam_tpu_torch/_build/`` (never
beside the source) on first use; the hash covers the source and the
flags, so an edited source is rebuilt. It exposes:

* ``preprocess_scan`` -- C++ ingest (invalid removal, azimuth relative
  time, ring-image packing), the semantics of ``dataio.preprocess``;
* ``read_kitti_bin`` -- raw ``.bin`` reader;
* ``Prefetcher`` -- threaded read-ahead and ingest over a KITTI velodyne
  directory, in order.

``available()`` is False when there is no compiler or the build fails;
callers then keep the numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("msf_loam_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-pthread"]

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmsf_runtime_{digest.hexdigest()[:12]}"
                                   ".so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        logger.warning("native runtime build failed: %s", e)
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        lib = ctypes.CDLL(so)
        lib.msf_preprocess_scan.restype = ctypes.c_int
        lib.msf_preprocess_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.msf_read_kitti_bin.restype = ctypes.c_int
        lib.msf_read_kitti_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int]
        lib.msf_prefetcher_create.restype = ctypes.c_void_p
        lib.msf_prefetcher_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int]
        lib.msf_prefetcher_next.restype = ctypes.c_int
        lib.msf_prefetcher_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.msf_prefetcher_destroy.restype = None
        lib.msf_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable (g++ build failed)")
    return lib


def preprocess_scan(xyz: np.ndarray, ring: Optional[np.ndarray],
                    min_range: float, scan_period: float, n_rings: int,
                    width: int, fov_up: float = 2.0, fov_down: float = -24.8
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """C++ ingest. Returns (xyz (R,W,3), rel_time (R,W), mask (R,W), kept)."""
    lib = _lib_or_raise()
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3:
        raise ValueError(f"xyz must be (N, 3), got {xyz.shape}")
    ring_ptr = None
    if ring is not None:
        ring = np.ascontiguousarray(ring, np.int32)
        if ring.shape != (xyz.shape[0],):
            raise ValueError("ring must hold one id a point")
        ring_ptr = ring.ctypes.data_as(ctypes.c_void_p)
    out_xyz = np.zeros((n_rings, width, 3), np.float32)
    out_rel = np.zeros((n_rings, width), np.float32)
    out_mask = np.zeros((n_rings, width), np.uint8)
    kept = lib.msf_preprocess_scan(
        xyz.ctypes.data_as(ctypes.c_void_p), ring_ptr, xyz.shape[0],
        min_range, scan_period, n_rings, width, fov_up, fov_down,
        out_xyz.ctypes.data_as(ctypes.c_void_p),
        out_rel.ctypes.data_as(ctypes.c_void_p),
        out_mask.ctypes.data_as(ctypes.c_void_p))
    return out_xyz, out_rel, out_mask.astype(bool), kept


def read_kitti_bin(path: str, max_points: int = 200_000) -> np.ndarray:
    lib = _lib_or_raise()
    buf = np.zeros((max_points, 4), np.float32)
    n = lib.msf_read_kitti_bin(path.encode(),
                               buf.ctypes.data_as(ctypes.c_void_p),
                               max_points)
    if n < 0:
        raise FileNotFoundError(path)
    return buf[:n]


class Prefetcher:
    """Threaded read-ahead over <dir>/000000.bin.. (in-order delivery)."""

    def __init__(self, velodyne_dir: str, n_frames: int, n_rings: int,
                 width: int, min_range: float = 0.3, scan_period: float = 0.1,
                 fov_up: float = 2.0, fov_down: float = -24.8,
                 n_threads: int = 2):
        self._lib = _lib_or_raise()
        self.n_rings, self.width = n_rings, width
        self._h = self._lib.msf_prefetcher_create(
            velodyne_dir.encode(), n_frames, n_rings, width, min_range,
            scan_period, fov_up, fov_down, n_threads)

    def __iter__(self):
        return self

    def __next__(self):
        out_xyz = np.zeros((self.n_rings, self.width, 3), np.float32)
        out_rel = np.zeros((self.n_rings, self.width), np.float32)
        out_mask = np.zeros((self.n_rings, self.width), np.uint8)
        n_kept = ctypes.c_int(0)
        idx = self._lib.msf_prefetcher_next(
            self._h, out_xyz.ctypes.data_as(ctypes.c_void_p),
            out_rel.ctypes.data_as(ctypes.c_void_p),
            out_mask.ctypes.data_as(ctypes.c_void_p), ctypes.byref(n_kept))
        if idx < 0:
            raise StopIteration
        return idx, out_xyz, out_rel, out_mask.astype(bool), n_kept.value

    def close(self):
        if self._h:
            self._lib.msf_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
