"""Data-parallel point-to-plane Gauss-Newton (port of the JAX package's
``parallel/data_parallel.py``): the correspondence rows split over the
mesh ``data`` axis, the normal equations summed with one all-reduce per
iteration, the 6x6 solve and the retraction replicated on every rank
(identical results, no further communication)."""

from __future__ import annotations

import torch

from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.parallel.mesh import Mesh, shard_over

Tensor = torch.Tensor


def dp_gauss_newton_plane(mesh: Mesh, pose0: Pose, points: Tensor,
                          plane_c: Tensor, plane_n: Tensor, valid: Tensor,
                          n_iters: int, huber_delta: float = 0.1) -> Pose:
    """Point-to-plane GN over all N correspondences (given whole on every
    rank; N divisible by the ``data`` axis): each rank evaluates its
    contiguous block of N/D rows, [H, g, n_in] are all-reduced, and every
    rank takes the same damped LU step (no step where n_in < 3)."""
    ax = mesh.axis("data")
    if points.shape[0] % ax.size:
        raise ValueError(f"{points.shape[0]} correspondences do not split "
                         f"over a {ax.size}-way data axis")
    pts, c, n, v = (shard_over(mesh, "data", x)
                    for x in (points, plane_c, plane_n, valid))
    pose = pose0
    for _ in range(n_iters):
        blocks = icp.plane_residuals(pose, pts, c, n, v)
        w = gn.huber_weights(blocks, huber_delta)
        H, g, _, n_in = gn.accumulate_normal_eqs([blocks], [w], 6)
        buf = ax.all_reduce(torch.cat([H.reshape(-1), g, n_in[None]]))
        H, g, n_in = buf[:36].view(6, 6), buf[36:42], buf[42]
        H = H + 1e-4 * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        dx = -torch.linalg.solve(H, g)
        dx = torch.where(n_in >= 3, dx, torch.zeros_like(dx))
        pose = pose.retract(dx)
    return pose
