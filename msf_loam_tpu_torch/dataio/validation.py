"""Scan stream validation and latency re-stamping (numpy).

The port's copy of the JAX package's ``dataio/validation.py``:
``validate_scan`` runs the checks of the reference's
``scripts/validate_velodyne_cloud_in_bag.py`` (per-point time present and
in range, ring ids in range, clockwise azimuth order) and
``restamp_latency`` its ``scripts/preprocess_bag_file.py`` 20 ms
sensor-latency shift.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def validate_scan(xyz: np.ndarray, ring: np.ndarray,
                  rel_time: Optional[np.ndarray] = None, n_rings: int = 128,
                  scan_period: float = 0.1) -> Dict[str, object]:
    """Returns {ok: bool, errors: [str]} for one scan."""
    errors: List[str] = []
    if not np.isfinite(xyz).all():
        errors.append("non-finite coordinates present")
    if ring.min(initial=0) < 0 or ring.max(initial=0) >= n_rings:
        errors.append(f"ring ids outside [0, {n_rings})")
    if rel_time is not None:
        if rel_time.min(initial=0.0) < 0:
            errors.append("negative relative time")
        if rel_time.max(initial=0.0) > 2 * scan_period:
            errors.append(f"relative time exceeds 2x scan period "
                          f"({rel_time.max():.4f})")
        # per-ring monotonicity (points are expected in firing order)
        for r in np.unique(ring):
            rt = rel_time[ring == r]
            if len(rt) > 1 and (np.diff(rt) < -1e-6).any():
                errors.append(f"ring {r}: relative time not monotonic")
                break
    # clockwise ordering: ori = -atan2(y, x) of the first points increases
    if len(xyz) > 100:
        ori = -np.arctan2(xyz[:100, 1], xyz[:100, 0])
        unwrapped = np.unwrap(ori)
        if unwrapped[-1] < unwrapped[0]:
            errors.append("points not in clockwise firing order")
    return {"ok": not errors, "errors": errors}


def restamp_latency(scan_times: np.ndarray, latency: float = 0.02
                    ) -> np.ndarray:
    """Shift scan timestamps by a simulated sensor latency."""
    return scan_times + latency
