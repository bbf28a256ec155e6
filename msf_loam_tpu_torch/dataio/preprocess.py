"""Host-side scan ingestion (numpy): invalid-point removal, per-point
relative time and ring grouping into a fixed-shape ``RingImage``.

A copy of the JAX package's ``dataio/preprocess.py`` that hands its result
to torch on the requested device; the numpy arithmetic is unchanged, so
both packages build byte-identical ring images from one scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.core.pointcloud import RingImage


def remove_invalid_points(xyz: np.ndarray, min_range: float,
                          extra: Optional[Tuple[np.ndarray, ...]] = None):
    """Drop non-finite points and points closer than min_range."""
    finite = np.isfinite(xyz).all(axis=1)
    rng = np.linalg.norm(xyz, axis=1) >= min_range
    keep = finite & rng
    if extra is None:
        return xyz[keep]
    return (xyz[keep],) + tuple(a[keep] for a in extra)


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
    numpy planes ``(xyz, rel_time, mask)``."""
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


def preprocess_scan(xyz: np.ndarray, ring: np.ndarray, cfg: FeatureConfig,
                    num_rings: int, rel_time: Optional[np.ndarray] = None,
                    device="cuda") -> RingImage:
    """Full host ingest: invalid removal -> rel time -> ring image on
    ``device``."""
    xyz, ring = remove_invalid_points(xyz, cfg.min_range, (ring,))
    if rel_time is None:
        rel_time = compute_relative_time(xyz, ring, cfg.scan_period)
    planes = build_ring_image_np(xyz, ring, rel_time, num_rings,
                                 cfg.max_points_per_ring)
    return RingImage(*(torch.from_numpy(a).to(device) for a in planes))


def infer_rings_from_elevation(xyz: np.ndarray, num_rings: int = 64,
                               fov_up: float = 2.0,
                               fov_down: float = -24.8) -> np.ndarray:
    """Ring index from elevation angle for datasets without a ring field
    (KITTI HDL-64E: +2 .. -24.8 degrees)."""
    d = np.linalg.norm(xyz[:, :2], axis=1)
    elev = np.degrees(np.arctan2(xyz[:, 2], d))
    frac = (fov_up - elev) / (fov_up - fov_down)
    ring = np.clip(np.round(frac * (num_rings - 1)), 0, num_rings - 1)
    return ring.astype(np.int32)
