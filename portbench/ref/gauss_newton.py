"""Batched on-manifold damped Gauss-Newton (port of the JAX package's
``ops/gauss_newton.py``).

Huber IRLS block weights, the reference's outlier rejections as weights
(an absolute threshold, a norm quantile), dense normal equations over a
6-dim pose or a 9-dim [pose, velocity] state (plain float32 products:
TF32 is off, see ``msf_loam_tpu_torch/__init__.py``), a small Cholesky
solve that maps a failed factorisation to a zero step without a host
synchronisation, and the SE(3) retraction.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from portbench.ref.se3 import Pose
from portbench.ref import icp_residuals as icp
from portbench.ref.icp_residuals import ResidualBlocks

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
        n_in = n_in + (w > 0).to(torch.get_default_dtype()).sum() * blocks.r.shape[-1]
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
                 step_clip: float = 1.0, group=None) -> GNState:
    """Fixed-iteration damped Gauss-Newton on a pose (state_dim 6) or on
    [pose, velocity] (state_dim 9, tangent [dt, dtheta, dv]).

    ``build_blocks(pose, velocity)`` returns (blocks_list, weights_list).
    ``group`` (a ``parallel.mesh.Axis``, JAX's ``axis_name``): the residual
    blocks are this rank's share; the normal equations [H, g, cost, n_in]
    are summed over the axis in one all-reduce of a packed buffer each
    iteration, before the replicated solve."""
    pose, vel = pose0, velocity0
    cost = n_in = None
    for _ in range(n_iters):
        blocks, weights = build_blocks(pose, vel)
        H, g, cost, n_in = accumulate_normal_eqs(blocks, weights, state_dim)
        if group is not None:
            d2 = state_dim * state_dim
            buf = group.all_reduce(torch.cat([H.reshape(-1), g, cost[None],
                                              n_in[None]]))
            H = buf[:d2].view(state_dim, state_dim)
            g = buf[d2:d2 + state_dim]
            cost, n_in = buf[d2 + state_dim], buf[d2 + state_dim + 1]
        H = H + damping * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        dx = -_solve_psd(H, g)
        dx = torch.clamp(dx, -step_clip, step_clip)
        dx = torch.where(n_in >= 3.0, dx, torch.zeros_like(dx))
        pose = pose.retract(dx[:6])
        if state_dim > 6:
            vel = vel + dx[6:9]
    return GNState(pose=pose, velocity=vel, cost=cost, n_inliers=n_in)


def solve_edge_plane(pose0: Pose, edges: Sequence[Tensor],
                     planes: Sequence[Tensor], huber_delta: float,
                     n_iters: int, group=None) -> GNState:
    """The rigid point-to-line + point-to-plane Gauss-Newton of the scan
    matchers, Huber-weighted; ``edges`` / ``planes`` are (points, centre,
    direction or normal, valid). With a leading lane axis on ``pose0`` and
    on every correspondence tensor each lane solves alone:
    ``torch.func.vmap`` batches every operation over the lanes, so the
    launches do not grow with their number."""
    def solve(pose, e, p):
        def build(q, v):
            eb = icp.edge_residuals(q, *e)
            pb = icp.plane_residuals(q, *p)
            return [eb, pb], [huber_weights(eb, huber_delta),
                              huber_weights(pb, huber_delta)]
        return gauss_newton(build, pose, torch.zeros_like(pose.t), n_iters,
                            group=group)

    if pose0.t.dim() == 1:
        return solve(pose0, edges, planes)
    if group is not None:
        raise ValueError("solve_edge_plane: a group takes one lane")
    return torch.func.vmap(solve)(pose0, tuple(edges), tuple(planes))
