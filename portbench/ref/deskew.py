"""Motion deskew from the scan-to-scan odometry step (a frozen copy of
``undistort_from_motion`` in the port's ``imu/deskew.py``)."""

from __future__ import annotations

import torch

from portbench.ref.pointcloud import PointBatch
from portbench.ref.se3 import Pose, quat_rotate, quat_slerp
from portbench.ref.voxel import div_scale

Tensor = torch.Tensor


def undistort_from_motion(pb: PointBatch, pose_c2l: Pose, frame_dt,
                          translation_only: bool = False) -> PointBatch:
    """Motion deskew from the scan-to-scan odometry step (the classic LOAM
    reprojection to scan start; constant velocity over the frame):
    p' = slerp(I, q, s) p + s t with s = clip(rel_time / frame_dt, 0, 1).
    ``translation_only`` skips the rotation (an IMU gyro deskew already
    removed it). A leading lane axis takes (B,) poses and (B, N) clouds.

    ``frame_dt`` sets how s is rounded, as the reference's call site does:
    a Python float multiplies by its float32 reciprocal (the compiled
    frames and matcher), a tensor divides (the reference's eager
    pre-initialisation call)."""
    s = div_scale(pb.rel_time, frame_dt).clamp(0.0, 1.0)
    xyz = pb.xyz
    if not translation_only:
        q1 = pose_c2l.q[..., None, :].expand(s.shape + (4,))
        ident = torch.zeros_like(q1)
        ident[..., 0] = 1.0
        xyz = quat_rotate(quat_slerp(ident, q1, s), xyz)
    return pb._replace(xyz=xyz + s[..., None] * pose_c2l.t[..., None, :])

