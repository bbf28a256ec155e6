"""Online IMU bias estimation over a window of mapped states (port of the
JAX package's ``imu/bias_estimator.py``).

A small Gauss-Newton over the last W+1 mapped frames solves for one shared
(ba, bg) and per-frame velocities, with the mapped poses held fixed. The
residuals are the preintegration factor's rows whitened by each window's
square-root information, plus weak zero-mean priors on the biases and a tie
of the velocities to their seeds. The Jacobian is forward-mode automatic
differentiation of the residual (``torch.func.jacfwd``), as the reference
takes it with ``jax.jacfwd``; a failed Cholesky factorisation is a zero
step, and a non-finite result keeps the previous estimate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msf_loam_tpu_torch.config import ImuConfig
from msf_loam_tpu_torch.imu.preintegration import (Preintegration,
                                                   evaluate_residual,
                                                   sqrt_information)

Tensor = torch.Tensor


class BiasSolveResult(NamedTuple):
    ba: Tensor          # (3,)
    bg: Tensor          # (3,)
    velocities: Tensor  # (W+1, 3)
    cost: Tensor        # () weighted cost at the last iteration


def solve_bias_window(poses_t: Tensor, poses_q: Tensor, vels0: Tensor,
                      pres: Preintegration, pair_valid: Tensor,
                      gravity: Tensor, ba0: Tensor, bg0: Tensor,
                      cfg: ImuConfig, n_iters: int = 8) -> BiasSolveResult:
    """poses_t / poses_q (W+1, 3|4) fixed anchors, vels0 (W+1, 3) seeds,
    ``pres`` a Preintegration whose fields carry a leading pair axis W,
    pair_valid (W,), gravity (3,), ba0 / bg0 warm starts."""
    W1 = poses_t.shape[0]
    sq_infos = sqrt_information(pres, cfg.sqrt_info_scale)   # (W, 15, 15)
    k = cfg.sqrt_info_scale

    def residuals(x: Tensor) -> Tensor:
        ba, bg, vels = x[0:3], x[3:6], x[6:].reshape(W1, 3)
        bab = ba.expand(W1 - 1, 3)
        bgb = bg.expand(W1 - 1, 3)
        r = evaluate_residual(pres, poses_t[:-1], poses_q[:-1], vels[:-1],
                              bab, bgb, poses_t[1:], poses_q[1:], vels[1:],
                              bab, bgb, gravity)
        r = (sq_infos @ r[..., None])[..., 0]                   # (W, 15)
        r = torch.where(pair_valid[:, None], r, torch.zeros_like(r))
        prior = torch.cat([(k / cfg.bias_prior_acc_sigma) * ba,
                           (k / cfg.bias_prior_gyr_sigma) * bg,
                           ((k / cfg.bias_vel_prior_sigma)
                            * (vels - vels0)).reshape(-1)])
        return torch.cat([r.reshape(-1), prior])

    jac = torch.func.jacfwd(residuals)
    x = torch.cat([ba0, bg0, vels0.reshape(-1)])
    cost = None
    for _ in range(n_iters):
        r = residuals(x)
        J = jac(x)
        H = J.T @ J
        g = J.T @ r
        H = H + 1e-6 * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        L, info = torch.linalg.cholesky_ex(H)
        dx = torch.cholesky_solve(g[:, None], L)[:, 0]
        ok = (info == 0) & torch.isfinite(dx).all()
        x = x - torch.where(ok, dx, torch.zeros_like(dx))
        cost = (r * r).sum()
    ba = torch.clamp(x[0:3], -cfg.bias_max_acc, cfg.bias_max_acc)
    bg = torch.clamp(x[3:6], -cfg.bias_max_gyr, cfg.bias_max_gyr)
    vels = x[6:].reshape(W1, 3)
    ok = torch.isfinite(torch.cat([ba, bg, vels.reshape(-1)])).all()
    return BiasSolveResult(ba=torch.where(ok, ba, ba0),
                           bg=torch.where(ok, bg, bg0),
                           velocities=torch.where(ok, vels, vels0), cost=cost)
