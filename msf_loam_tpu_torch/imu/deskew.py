"""Scan undistortion from IMU preintegration (port of the JAX package's
``imu/deskew.py``): per-point deskew terms for the tightly-coupled factors,
the pre-initialisation rotation-only deskew and the post-initialisation
full deskew with velocity and gravity terms."""

from __future__ import annotations

import torch

from msf_loam_tpu_torch.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose, quat_conjugate, quat_rotate
from msf_loam_tpu_torch.imu.preintegration import (Preintegration,
                                                   interpolate_delta)
from msf_loam_tpu_torch.ops.icp_residuals import DeskewTerms

Tensor = torch.Tensor

_CLOUDS = ("full", "corner_sharp", "corner_less_sharp", "surf_flat",
           "surf_less_flat")


def deskew_terms(pre: Preintegration, rel_time: Tensor,
                 gravity: Tensor) -> DeskewTerms:
    """Per-point (delta_p, delta_q, dt) for the tightly-coupled factors."""
    dp, dq = interpolate_delta(pre, rel_time)
    return DeskewTerms(delta_p=dp, delta_q=dq, dt=rel_time, gravity=gravity)


def undistort_rotation_only(pb: PointBatch, pre: Preintegration) -> PointBatch:
    """Pre-initialisation deskew: rotate each point by its interpolated
    delta_q."""
    _, dq = interpolate_delta(pre, pb.rel_time)
    return pb._replace(xyz=quat_rotate(dq, pb.xyz))


def undistort_full(pb: PointBatch, pre: Preintegration, pose: Pose,
                   velocity: Tensor, gravity: Tensor) -> PointBatch:
    """Post-initialisation deskew with velocity and gravity compensation:
    p' = dq p + R^T (v dt - 0.5 g dt^2) + dp."""
    dp, dq = interpolate_delta(pre, pb.rel_time)
    dt = pb.rel_time[:, None]
    world_term = velocity[None, :] * dt - 0.5 * gravity[None, :] * dt * dt
    body_term = quat_rotate(quat_conjugate(pose.q), world_term)
    return pb._replace(xyz=quat_rotate(dq, pb.xyz) + body_term + dp)


def undistort_scan_rotation_only(scan: ScanFeatures,
                                 pre: Preintegration) -> ScanFeatures:
    """Rotation-only deskew of all five clouds."""
    return scan._replace(**{c: undistort_rotation_only(getattr(scan, c), pre)
                            for c in _CLOUDS})


def undistort_scan_full(scan: ScanFeatures, pre: Preintegration, pose: Pose,
                        velocity: Tensor, gravity: Tensor) -> ScanFeatures:
    """Full deskew of all five clouds."""
    return scan._replace(**{c: undistort_full(getattr(scan, c), pre, pose,
                                              velocity, gravity)
                            for c in _CLOUDS})
