"""The 15-dim IMU preintegration factor with analytic Jacobians (port of
the JAX package's ``imu/imu_factor.py``).

The residual between states i and j is whitened by the square-root
information of the window; its Jacobian is taken with respect to the free
state of the pre-solve and the tight matcher, [pose_j tangent (6), v_j (3)]
(``imu_factor_blocks``, or its frame-constant / per-iteration split
``imu_factor_prep`` + ``imu_factor_blocks_from_prep``), or with respect
to all four state blocks (``imu_factor_full``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msf_loam_tpu_torch.core.se3 import (Pose, quat_conjugate, quat_left,
                                         quat_multiply, quat_right,
                                         quat_rotate, quat_to_matrix, skew)
from msf_loam_tpu_torch.imu.preintegration import (O_BA, O_BG, O_P, O_R, O_V,
                                                   Preintegration,
                                                   bias_blocks,
                                                   corrected_deltas,
                                                   evaluate_residual,
                                                   matvec, sqrt_information)
from msf_loam_tpu_torch.ops.icp_residuals import ResidualBlocks

Tensor = torch.Tensor


class ImuState(NamedTuple):
    """Full 15-dim navigation state."""

    pose: Pose
    v: Tensor    # (3,)
    ba: Tensor   # (3,)
    bg: Tensor   # (3,)


def _blocks(rw: Tensor, Jw: Tensor) -> ResidualBlocks:
    return ResidualBlocks(r=rw[None, :], J=Jw[None, :, :],
                          valid=torch.ones((1,), dtype=torch.bool,
                                           device=rw.device))


def imu_factor_blocks(pre: Preintegration, state_i: ImuState,
                      state_j: ImuState, gravity: Tensor,
                      info_scale: float = 0.001,
                      sqrt_info: Tensor = None) -> ResidualBlocks:
    """Whitened residual and Jacobian with respect to [dpose_j, dv_j]:
    d r_p / d p_j = R_i^T, d r_q / d theta_j = Qleft(dq^-1 q_i^-1 q_j)[1:,1:],
    d r_v / d v_j = R_i^T."""
    r = evaluate_residual(
        pre, state_i.pose.t, state_i.pose.q, state_i.v, state_i.ba,
        state_i.bg, state_j.pose.t, state_j.pose.q, state_j.v, state_j.ba,
        state_j.bg, gravity)
    if sqrt_info is None:
        sqrt_info = sqrt_information(pre, info_scale)
    Ri_inv = quat_to_matrix(state_i.pose.q).T
    _, corrected_q, _ = corrected_deltas(pre, state_i.ba, state_i.bg)
    J = torch.zeros((15, 9), device=r.device)
    J[O_P:O_P + 3, 0:3] = Ri_inv
    rel_q = quat_multiply(quat_conjugate(corrected_q),
                          quat_multiply(quat_conjugate(state_i.pose.q),
                                        state_j.pose.q))
    J[O_R:O_R + 3, 3:6] = quat_left(rel_q)[1:4, 1:4]
    J[O_V:O_V + 3, 6:9] = Ri_inv
    return _blocks(matvec(sqrt_info, r), sqrt_info @ J)


class ImuFactorPrep(NamedTuple):
    """The parts of the factor that do not depend on (pose_j, v_j),
    computed once per frame for the tight Gauss-Newton."""
    A: Tensor          # (3, 3) R_i^T
    c_p: Tensor        # (3,) constant part of r_p
    c_v: Tensor        # (3,) constant part of r_v
    qc: Tensor         # (4,) conj(corrected_q) * conj(q_i)
    Jw_const: Tensor   # (15, 9) whitened Jacobian, rel_q block zero
    sq_rot: Tensor     # (15, 3) sqrt_info columns O_R:O_R+3
    sqrt_info: Tensor  # (15, 15)


def imu_factor_prep(pre: Preintegration, state_i: ImuState, gravity: Tensor,
                    sqrt_info: Tensor = None,
                    info_scale: float = 0.001) -> ImuFactorPrep:
    """The state_j-independent half of ``imu_factor_blocks`` (state_j's
    biases equal state_i's, so r_ba = r_bg = 0)."""
    if sqrt_info is None:
        sqrt_info = sqrt_information(pre, info_scale)
    corrected_p, corrected_q, corrected_v = corrected_deltas(
        pre, state_i.ba, state_i.bg)
    qi_inv = quat_conjugate(state_i.pose.q)
    A = quat_to_matrix(state_i.pose.q).T
    sdt = pre.sum_dt
    c_p = matvec(A, 0.5 * gravity * sdt * sdt - state_i.pose.t
                 - state_i.v * sdt) - corrected_p
    c_v = matvec(A, gravity * sdt - state_i.v) - corrected_v
    qc = quat_multiply(quat_conjugate(corrected_q), qi_inv)
    J = torch.zeros((15, 9), device=A.device)
    J[O_P:O_P + 3, 0:3] = A
    J[O_V:O_V + 3, 6:9] = A
    return ImuFactorPrep(A=A, c_p=c_p, c_v=c_v, qc=qc,
                         Jw_const=sqrt_info @ J,
                         sq_rot=sqrt_info[:, O_R:O_R + 3],
                         sqrt_info=sqrt_info)


def imu_factor_blocks_from_prep(prep: ImuFactorPrep, pose_j: Pose,
                                v_j: Tensor) -> ResidualBlocks:
    """The per-iteration half of the decomposed factor."""
    rel_q = quat_multiply(prep.qc, pose_j.q)
    r_p = matvec(prep.A, pose_j.t) + prep.c_p
    r_q = 2.0 * rel_q[1:4]
    r_v = matvec(prep.A, v_j) + prep.c_v
    r = torch.cat([r_p, r_q, r_v, torch.zeros(6, device=r_p.device)])
    Jw = prep.Jw_const.clone()
    Jw[:, 3:6] += prep.sq_rot @ quat_left(rel_q)[1:4, 1:4]
    return _blocks(matvec(prep.sqrt_info, r), Jw)


def imu_factor_full(pre: Preintegration, state_i: ImuState,
                    state_j: ImuState, gravity: Tensor,
                    info_scale: float = 0.001, sqrt_info: Tensor = None):
    """Whitened residual (15,) and the full analytic Jacobian (15, 30) over
    [pose_i (6), v_i ba_i bg_i (9), pose_j (6), v_j ba_j bg_j (9)]."""
    r = evaluate_residual(
        pre, state_i.pose.t, state_i.pose.q, state_i.v, state_i.ba,
        state_i.bg, state_j.pose.t, state_j.pose.q, state_j.v, state_j.ba,
        state_j.bg, gravity)
    if sqrt_info is None:
        sqrt_info = sqrt_information(pre, info_scale)
    sdt = pre.sum_dt
    dp_dba, dp_dbg, dq_dbg, dv_dba, dv_dbg = bias_blocks(pre)

    Ri_inv = quat_to_matrix(state_i.pose.q).T
    qi_inv = quat_conjugate(state_i.pose.q)
    _, corrected_q, _ = corrected_deltas(pre, state_i.ba, state_i.bg)
    qj_inv_qi = quat_multiply(quat_conjugate(state_j.pose.q), state_i.pose.q)
    eye = torch.eye(3, device=r.device)

    Jf = torch.zeros((15, 30), device=r.device)
    Jf[O_P:O_P + 3, 0:3] = -Ri_inv
    Jf[O_P:O_P + 3, 3:6] = skew(quat_rotate(
        qi_inv, 0.5 * gravity * sdt * sdt + state_j.pose.t - state_i.pose.t
        - state_i.v * sdt))
    Jf[O_R:O_R + 3, 3:6] = -(quat_left(qj_inv_qi)
                             @ quat_right(corrected_q))[1:4, 1:4]
    Jf[O_V:O_V + 3, 3:6] = skew(quat_rotate(
        qi_inv, gravity * sdt + state_j.v - state_i.v))
    Jf[O_P:O_P + 3, 6:9] = -Ri_inv * sdt
    Jf[O_P:O_P + 3, 9:12] = -dp_dba
    Jf[O_P:O_P + 3, 12:15] = -dp_dbg
    Jf[O_R:O_R + 3, 12:15] = -quat_left(quat_multiply(
        qj_inv_qi, corrected_q))[1:4, 1:4] @ dq_dbg
    Jf[O_V:O_V + 3, 6:9] = -Ri_inv
    Jf[O_V:O_V + 3, 9:12] = -dv_dba
    Jf[O_V:O_V + 3, 12:15] = -dv_dbg
    Jf[O_BA:O_BA + 3, 9:12] = -eye
    Jf[O_BG:O_BG + 3, 12:15] = -eye
    Jf[O_P:O_P + 3, 15:18] = Ri_inv
    rel_q = quat_multiply(quat_conjugate(corrected_q),
                          quat_multiply(qi_inv, state_j.pose.q))
    Jf[O_R:O_R + 3, 18:21] = quat_left(rel_q)[1:4, 1:4]
    Jf[O_V:O_V + 3, 21:24] = Ri_inv
    Jf[O_BA:O_BA + 3, 24:27] = eye
    Jf[O_BG:O_BG + 3, 27:30] = eye
    return matvec(sqrt_info, r), sqrt_info @ Jf


def imu_presolve(pre: Preintegration, prev_state: ImuState, gravity: Tensor,
                 n_iters: int = 6, info_scale: float = 0.001) -> ImuState:
    """IMU-only prediction of state j: Gauss-Newton on the factor from
    state i with pose_j and v_j free and state_j's biases tied to state_i's."""
    from msf_loam_tpu_torch.ops import gauss_newton as gn

    sq_info = sqrt_information(pre, info_scale)
    one = torch.ones((1,), device=gravity.device)

    def build(pose_j, v_j):
        state_j = ImuState(pose_j, v_j, prev_state.ba, prev_state.bg)
        return [imu_factor_blocks(pre, prev_state, state_j, gravity,
                                  info_scale, sqrt_info=sq_info)], [one]

    out = gn.gauss_newton(build, prev_state.pose, prev_state.v,
                          n_iters=n_iters, state_dim=9)
    return ImuState(out.pose, out.velocity, prev_state.ba, prev_state.bg)
