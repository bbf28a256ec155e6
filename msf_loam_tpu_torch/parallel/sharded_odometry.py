"""Scan-to-scan odometry with the query rows split over the mesh ``map``
axis (port of the JAX package's ``parallel/sharded_odometry.py``).

Rank r takes the contiguous block r of each query cloud's rows (JAX's
``P("map")``); the reference clouds stay whole on every rank. Each rank
launches odo_corr, and select_fit for the plane fit, on its own rows;
``odometry.match_clouds(..., group=)`` sums the correspondence count each
round and the normal equations each Gauss-Newton iteration (one
all-reduce each), so every rank ends with the same pose. Against the
dense matcher only the summation order of H and g differs.

Where a query cloud's rows do not divide the axis, the JAX package falls
back to the dense matcher silently; the port warns (once per shape) and
then runs the dense matcher on every rank.
"""

from __future__ import annotations

import warnings

from msf_loam_tpu_torch.config import OdometryConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.parallel.mesh import Mesh
from msf_loam_tpu_torch.slam import odometry

_AXIS = "map"          # the axis the sharded map shards over
_WARNED = set()


def _rows(pb: PointBatch, r: int, n: int) -> PointBatch:
    sl = slice(r * n, (r + 1) * n)
    return PointBatch(pb.xyz[sl], pb.rel_time[sl], pb.ring[sl], pb.mask[sl])


def sharded_match_scan2scan(mesh: Mesh, scan_last: ScanFeatures,
                            scan_curr: ScanFeatures, pose0: Pose,
                            cfg: OdometryConfig):
    """Drop-in for ``odometry.match_scan2scan`` with the query rows split
    over the ``map`` axis."""
    ax = mesh.axis(_AXIS)
    nc = scan_curr.corner_sharp.xyz.shape[0]
    ns = scan_curr.surf_flat.xyz.shape[0]
    if nc % ax.size or ns % ax.size:
        if (nc, ns, ax.size) not in _WARNED:
            _WARNED.add((nc, ns, ax.size))
            warnings.warn(
                f"sharded_match_scan2scan: query rows ({nc} corner, {ns} "
                f"surface) do not divide the {ax.size}-way map axis; "
                f"running the dense matcher on every rank", RuntimeWarning)
        return odometry.match_scan2scan(scan_last, scan_curr, pose0, cfg)
    r = ax.index
    return odometry.match_clouds(
        scan_last.corner_less_sharp, scan_last.surf_less_flat,
        _rows(scan_curr.corner_sharp, r, nc // ax.size),
        _rows(scan_curr.surf_flat, r, ns // ax.size), pose0, cfg, group=ax)
