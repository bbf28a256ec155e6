"""Point-to-line / point-to-plane residuals with analytic Jacobians over
all correspondences at once (port of the JAX package's
``ops/icp_residuals.py``): the rigid variants over [dt, dtheta] (zero
padded to a wider state on request) and the IMU-deskew variants over the
9-dim [dt, dtheta, dv] state.

Tangent convention [dt, dtheta] with q <- q * exp(dtheta), so
d(R p)/dtheta = -R skew(p).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.ref.se3 import Pose, quat_rotate, quat_to_matrix, skew

Tensor = torch.Tensor


class ResidualBlocks(NamedTuple):
    """r: (N, R) residuals; J: (N, R, D) Jacobians; valid: (N,) bool."""

    r: Tensor
    J: Tensor
    valid: Tensor


def _pad_state(J: Tensor, state_dim: int) -> Tensor:
    if state_dim > J.shape[-1]:
        J = torch.nn.functional.pad(J, (0, state_dim - J.shape[-1]))
    return J


def edge_residuals(pose: Pose, points: Tensor, line_c: Tensor,
                   line_n: Tensor, valid: Tensor,
                   state_dim: int = 6) -> ResidualBlocks:
    """Point-to-line r = N x (R p + t - C); dr/dt = skew(N),
    dr/dtheta = -skew(N) R skew(p)."""
    R = quat_to_matrix(pose.q)
    p_w = points @ R.T + pose.t
    Nx = skew(line_n)
    r = torch.einsum("nij,nj->ni", Nx, p_w - line_c)
    J_th = -torch.einsum("nij,jk,nkl->nil", Nx, R, skew(points))
    return ResidualBlocks(r, _pad_state(torch.cat([Nx, J_th], dim=-1),
                                        state_dim), valid)


def plane_residuals(pose: Pose, points: Tensor, plane_c: Tensor,
                    plane_n: Tensor, valid: Tensor,
                    state_dim: int = 6) -> ResidualBlocks:
    """Point-to-plane r = N . (R p + t - C)."""
    R = quat_to_matrix(pose.q)
    p_w = points @ R.T + pose.t
    r = (plane_n * (p_w - plane_c)).sum(dim=-1)[:, None]
    J_th = -torch.einsum("ni,ij,njk->nk", plane_n, R, skew(points))[:, None, :]
    J = torch.cat([plane_n[:, None, :], J_th], dim=-1)
    return ResidualBlocks(r, _pad_state(J, state_dim), valid)

