"""Batched on-manifold damped Gauss-Newton (port of the JAX package's
``ops/gauss_newton.py``).

Huber IRLS block weights, dense normal equations over a 6-dim pose or a
9-dim [pose, velocity] state (plain float32 products: TF32 is off, see
``msf_loam_tpu_torch/__init__.py``), a small Cholesky solve that maps a
failed factorisation to a zero step without a host synchronisation, and
the SE(3) retraction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.ops.icp_residuals import ResidualBlocks

Tensor = torch.Tensor


def huber_weights(blocks: ResidualBlocks, delta: float) -> Tensor:
    """IRLS weights for a Huber loss on the block norm: min(1, d/|r|)."""
    nrm = torch.sqrt((blocks.r * blocks.r).sum(dim=-1) + 1e-30)
    w = torch.clamp(delta / nrm, max=1.0)
    return torch.where(blocks.valid, w, torch.zeros_like(w))


def accumulate_normal_eqs(blocks_list: Sequence[ResidualBlocks],
                          weights_list: Sequence[Tensor], dim: int
                          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Weighted normal equations summed over residual block sets:
    (H (dim, dim), g (dim,), cost, n_inliers)."""
    dev = blocks_list[0].r.device
    H = torch.zeros((dim, dim), device=dev)
    g = torch.zeros((dim,), device=dev)
    cost = torch.zeros((), device=dev)
    n_in = torch.zeros((), device=dev)
    for blocks, w in zip(blocks_list, weights_list):
        Jw = blocks.J * w[:, None, None]
        H = H + torch.einsum("nri,nrj->ij", Jw, blocks.J)
        g = g + torch.einsum("nri,nr->i", Jw, blocks.r)
        cost = cost + (w * (blocks.r * blocks.r).sum(dim=-1)).sum()
        n_in = n_in + (w > 0).float().sum() * blocks.r.shape[-1]
    return H, g, cost, n_in


class GNState(NamedTuple):
    pose: Pose
    velocity: Tensor     # (3,): the 9-dim state's velocity; else unchanged
    cost: Tensor
    n_inliers: Tensor


def _solve_psd(H: Tensor, g: Tensor) -> Tensor:
    """Cholesky solve of a small PSD system; a failed factorisation or a
    non-finite solution gives a zero step (cholesky_ex does not raise or
    synchronise)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[:, None], L)[:, 0]
    ok = (info == 0) & torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x))


def gauss_newton(build_blocks: Callable[[Pose, Tensor],
                                        Tuple[Sequence[ResidualBlocks],
                                              Sequence[Tensor]]],
                 pose0: Pose, velocity0: Tensor, n_iters: int,
                 state_dim: int = 6, damping: float = 1e-4,
                 step_clip: float = 1.0) -> GNState:
    """Fixed-iteration damped Gauss-Newton on a pose (state_dim 6) or on
    [pose, velocity] (state_dim 9, tangent [dt, dtheta, dv]).

    ``build_blocks(pose, velocity)`` returns (blocks_list, weights_list)."""
    pose, vel = pose0, velocity0
    cost = n_in = None
    for _ in range(n_iters):
        blocks, weights = build_blocks(pose, vel)
        H, g, cost, n_in = accumulate_normal_eqs(blocks, weights, state_dim)
        H = H + damping * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        dx = -_solve_psd(H, g)
        dx = torch.clamp(dx, -step_clip, step_clip)
        dx = torch.where(n_in >= 3.0, dx, torch.zeros_like(dx))
        pose = pose.retract(dx[:6])
        if state_dim > 6:
            vel = vel + dx[6:9]
    return GNState(pose=pose, velocity=vel, cost=cost, n_inliers=n_in)
