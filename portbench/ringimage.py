"""Frozen copy of the port's host ingest (numpy): invalid-point removal,
per-point relative time from the azimuth, and the front-packed ring image.

Copied from ``msf_loam_tpu_torch/dataio/preprocess.py`` with the numpy
arithmetic unchanged (held bit-equal to it in ``portbench/tests``), so the
benchmark builds the ring images that both the program and the check see.
"""

from __future__ import annotations

import numpy as np


def remove_invalid_points(xyz: np.ndarray, ring: np.ndarray,
                          min_range: float):
    """Drop non-finite points and points closer than ``min_range``."""
    keep = np.isfinite(xyz).all(axis=1) & \
        (np.linalg.norm(xyz, axis=1) >= min_range)
    return xyz[keep], ring[keep]


def compute_relative_time(xyz: np.ndarray, ring: np.ndarray,
                          scan_period: float = 0.1,
                          margin: float = np.pi / 12) -> np.ndarray:
    """Per-point relative time from a noise-robust azimuth unwrap: the mod
    window is shifted by ``margin`` so jitter at the scan start lands near
    0, and a wrap is declared only on a genuine ~2 pi drop, sticky for the
    rest of the ring."""
    if len(xyz) == 0:
        return np.zeros((0,), np.float32)
    start_ori = -np.arctan2(xyz[0, 1], xyz[0, 0])
    ori = -np.arctan2(xyz[:, 1], xyz[:, 0])
    rel = np.mod(ori - start_ori + margin, 2 * np.pi) - margin
    out = rel.copy()
    for r in np.unique(ring):
        sel = ring == r
        rr = rel[sel]
        run_max_before = np.concatenate([[-np.inf],
                                         np.maximum.accumulate(rr)[:-1]])
        wrapped = np.maximum.accumulate((run_max_before - rr) > np.pi)
        out[sel] = rr + 2 * np.pi * wrapped
    out = np.maximum(out, 0.0)
    return (out / (2 * np.pi) * scan_period).astype(np.float32)


def build_ring_image_np(xyz: np.ndarray, ring: np.ndarray,
                        rel_time: np.ndarray, num_rings: int, width: int):
    """Group points by ring (order-preserving) into front-packed (R, W)
    planes ``(xyz, rel_time, mask)``."""
    out_xyz = np.zeros((num_rings, width, 3), np.float32)
    out_t = np.zeros((num_rings, width), np.float32)
    out_m = np.zeros((num_rings, width), bool)
    for r in range(num_rings):
        sel = np.flatnonzero(ring == r)[:width]
        k = len(sel)
        out_xyz[r, :k] = xyz[sel]
        out_t[r, :k] = rel_time[sel]
        out_m[r, :k] = True
    return out_xyz, out_t, out_m


def ring_image(xyz: np.ndarray, ring: np.ndarray, num_rings: int,
               width: int, min_range: float, scan_period: float):
    """One scan's ring image planes ``(xyz, rel_time, mask)``."""
    xyz, ring = remove_invalid_points(xyz, ring, min_range)
    rel = compute_relative_time(xyz, ring, scan_period)
    return build_ring_image_np(xyz, ring, rel, num_rings, width)
