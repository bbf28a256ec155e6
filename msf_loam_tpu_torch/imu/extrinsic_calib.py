"""LiDAR-IMU extrinsic rotation calibration (hand-eye on SO(3)).

The port of the JAX package's ``imu/extrinsic_calib.py``, the batched
redesign of the reference's ``InitialEXRotation::CalibrationExRotation``:
for frame-pair rotations (dq_lidar_k, dq_imu_k) with dq_lidar (x) q_ric ==
q_ric (x) dq_imu, stack the 4x4 blocks huber_k * (L(dq_lidar_k) -
R(dq_imu_k)) and take the right-singular vector of the smallest singular
value, re-weighting by the current estimate a few times. Runs on the
device of its inputs; the SVD is ``torch.linalg.svd``.

The singular vector is defined only up to sign; each iteration fixes it by
w >= 0 (the JAX package's rule), so the two agree on q, not only on +-q.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msf_loam_tpu_torch.core.se3 import (quat_conjugate, quat_exp,
                                         quat_left, quat_multiply,
                                         quat_normalize, quat_right)

Tensor = torch.Tensor


class CalibResult(NamedTuple):
    q_ric: Tensor          # (4,) wxyz lidar->imu rotation
    singular_gate: Tensor  # () second-smallest singular value
    converged: Tensor      # () bool: sigma[1] > gate with >= 10 pairs


def _angular_distance_deg(q1: Tensor, q2: Tensor) -> Tensor:
    d = quat_multiply(quat_conjugate(q1), q2)
    w = torch.clamp(torch.abs(d[..., 0]), -1.0, 1.0)
    return torch.rad2deg(2.0 * torch.arccos(w))


def calibrate_extrinsic_rotation(dq_lidar: Tensor, dq_imu: Tensor,
                                 valid: Tensor, sigma_gate: float = 0.25,
                                 huber_deg: float = 5.0,
                                 iterations: int = 3) -> CalibResult:
    """Estimate the lidar->imu rotation from paired frame deltas.

    Args:
      dq_lidar: (N, 4) wxyz per-pair lidar rotations.
      dq_imu:   (N, 4) wxyz per-pair gyro-integrated rotations.
      valid:    (N,) bool.
    """
    L = quat_left(dq_lidar)    # (N, 4, 4)
    R = quat_right(dq_imu)
    q_ric = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dq_lidar.dtype,
                         device=dq_lidar.device)
    sigma1 = torch.zeros((), dtype=dq_lidar.dtype, device=dq_lidar.device)
    for _ in range(iterations):
        # Huber weights by angular disagreement under the current estimate
        pred = quat_multiply(quat_multiply(q_ric, dq_imu),
                             quat_conjugate(q_ric))
        ang = _angular_distance_deg(dq_lidar, pred)
        huber = torch.where(ang > huber_deg,
                            huber_deg / torch.clamp(ang, min=1e-9),
                            torch.ones_like(ang))
        w = torch.where(valid, huber, torch.zeros_like(huber))
        A2 = ((L - R) * w[:, None, None]).reshape(-1, 4)
        _, s, Vh = torch.linalg.svd(A2, full_matrices=False)
        q_ric = quat_normalize(Vh[3])
        q_ric = torch.where(q_ric[0] < 0, -q_ric, q_ric)
        sigma1 = s[2]          # second-smallest of the 4 singular values
    n_valid = valid.to(torch.int32).sum()
    return CalibResult(q_ric=q_ric, singular_gate=sigma1,
                       converged=(n_valid >= 10) & (sigma1 > sigma_gate))


def integrate_gyro_rotation(gyr: Tensor, dts: Tensor, valid: Tensor
                            ) -> Tensor:
    """Gyro-only delta rotation over a window (the reference calibration
    tool's integration). Returns (4,) wxyz."""
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=gyr.dtype,
                     device=gyr.device)
    dq = quat_exp(gyr * dts[:, None])
    for k in range(gyr.shape[0]):
        q = torch.where(valid[k], quat_normalize(quat_multiply(q, dq[k])), q)
    return q
