"""Gravity direction and per-frame velocity initialisation (port of the JAX
package's ``imu/gravity_init.py``).

The velocity/gravity residuals are linear in x = [g, v_0..v_{N-1}], so one
dense damped least-squares system is solved, g is projected back onto the
gravity sphere and the velocities re-solved; the worst ``reject_frac`` of
residual blocks are then dropped and both solves repeat. Per consecutive
pair (i, j):
  r_p = q_i^-1 (p_i - p_j + v_i dt - 0.5 g dt^2) + delta_p_ij
  r_v = dt * (q_i^-1 (v_i - v_j - g dt) + delta_v_ij)
A singular system gives non-finite values, never an exception (the
pipeline's watchdog reads them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from msf_loam_tpu_torch.core.se3 import quat_conjugate, quat_to_matrix

Tensor = torch.Tensor


class GravityInitResult(NamedTuple):
    gravity: Tensor      # (3,) with |g| = |g0|
    velocities: Tensor   # (N, 3)
    residual_rms: Tensor


def _assemble(p: Tensor, q: Tensor, dt: Tensor, delta_p: Tensor,
              delta_v: Tensor, valid_pair: Tensor, n_frames: int):
    """Rows of the linear system in x = [g(3), v_0..v_{N-1}]:
    A (M, 6, D), b (M, 6) with residual A x + b, and pair weights w (M,)."""
    N = n_frames
    M = N - 1
    dev = p.device
    Ri_inv = quat_to_matrix(quat_conjugate(q[:-1]))   # (M, 3, 3)
    dt_ = dt[:, None, None]
    A = torch.zeros((M, 6, 3 + 3 * N), device=dev)
    A[:, 0:3, 0:3] = -0.5 * dt_ * dt_ * Ri_inv
    A[:, 3:6, 0:3] = -dt_ * dt_ * Ri_inv
    m = torch.arange(M, device=dev)[:, None, None]
    k = torch.arange(3, device=dev)[None, :, None]
    col_i = 3 + 3 * m + torch.arange(3, device=dev)[None, None, :]
    A[m, k, col_i] = dt_ * Ri_inv
    A[m, 3 + k, col_i] = dt_ * Ri_inv
    A[m, 3 + k, col_i + 3] = -dt_ * Ri_inv
    b_p = torch.einsum("mij,mj->mi", Ri_inv, p[:-1] - p[1:]) + delta_p
    b_v = dt[:, None] * delta_v
    return A, torch.cat([b_p, b_v], dim=1), valid_pair.float()


def _weighted_solve(A: Tensor, b: Tensor, w: Tensor,
                    g_fixed: Optional[Tensor],
                    x_prior: Optional[Tensor] = None,
                    damping: float = 1e-6) -> Tensor:
    """min ||w (A x + b)||^2 + damping ||x - x_prior||^2, optionally with
    g = g_fixed (its columns eliminated)."""
    M, R, D = A.shape
    Af = (A * w[:, None, None]).reshape(M * R, D)
    bf = (b * w[:, None]).reshape(M * R)
    if g_fixed is not None:
        bf = bf + Af[:, 0:3] @ g_fixed
        Af = Af.clone()
        Af[:, 0:3] = 0.0
    H = Af.T @ Af + damping * torch.eye(D, device=A.device)
    rhs = -Af.T @ bf
    if x_prior is not None:
        rhs = rhs + damping * x_prior
    x, _ = torch.linalg.solve_ex(H, rhs)
    if g_fixed is not None:
        x = torch.cat([g_fixed, x[3:]])
    return x


def masked_quantile(x: Tensor, mask: Tensor, q: float) -> Tensor:
    """q-quantile of x over the masked entries (static shape)."""
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, 3e38))).values
    n = mask.sum(dtype=torch.int32)
    idx = torch.clamp((q * n.float()).to(torch.int32), 0, x.shape[0] - 1)
    return xs[idx.long()[None]][0]


def _project(g: Tensor, g_norm: Tensor) -> Tensor:
    return g / torch.clamp(torch.linalg.vector_norm(g), min=1e-9) * g_norm


def solve_gravity_velocity(p: Tensor, q: Tensor, dt: Tensor, delta_p: Tensor,
                           delta_v: Tensor, valid_pair: Tensor, g0: Tensor,
                           n_frames: int,
                           reject_frac: float = 0.15) -> GravityInitResult:
    """p (N, 3) mapped positions, q (N, 4) orientations, dt (N-1,) pair
    gaps, delta_p / delta_v (N-1, 3) preintegrated, valid_pair (N-1,),
    g0 (3,) initial gravity (sets the norm)."""
    g_norm = torch.linalg.vector_norm(g0)
    A, b, w = _assemble(p, q, dt, delta_p, delta_v, valid_pair, n_frames)
    x = _weighted_solve(A, b, w, None)
    x = _weighted_solve(A, b, w, _project(x[0:3], g_norm), x_prior=x)

    r = torch.einsum("mrd,d->mr", A, x) + b
    block_norm = torch.linalg.vector_norm(r, dim=1)
    block_norm = torch.where(w > 0, block_norm, torch.full_like(block_norm, -1.0))
    thr = masked_quantile(block_norm, w > 0, 1.0 - reject_frac)
    w2 = w * (block_norm <= thr).float()
    x = _weighted_solve(A, b, w2, None, x_prior=x)
    g = _project(x[0:3], g_norm)
    x = _weighted_solve(A, b, w2, g, x_prior=x)

    r = torch.einsum("mrd,d->mr", A, x) + b
    rms = torch.sqrt(torch.mean((r * r).sum(dim=1) * w2) + 1e-12)
    return GravityInitResult(gravity=g, velocities=x[3:].reshape(n_frames, 3),
                             residual_rms=rms)
