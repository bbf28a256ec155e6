"""VINS-Mono-style IMU preintegration on torch tensors (port of the JAX
package's ``imu/preintegration.py``).

Midpoint integration of (delta_p, delta_q, delta_v) with the 15x15 bias
Jacobian and covariance propagation, per-sample result buffers for the
per-point deskew interpolation, the bias-corrected residual and the
whitening matrix. A window holds S samples; padding has dt = 0 and is an
exact no-op. State order: O_P=0, O_R=3, O_V=6, O_BA=9, O_BG=12.

Two lowerings, chosen by ``ImuConfig.preint_mode``: "assoc" writes the
recurrences as log-depth associative scans (``associative_scan`` below
follows ``jax.lax.associative_scan``'s odd/even recursion, so products are
formed in the reference's order); "scan" is the literal per-sample loop.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from msf_loam_tpu_torch.config import ImuConfig
from msf_loam_tpu_torch.core.se3 import (quat_conjugate, quat_exp,
                                         quat_multiply, quat_normalize,
                                         quat_rotate, quat_slerp,
                                         quat_to_matrix, skew)

Tensor = torch.Tensor

O_P, O_R, O_V, O_BA, O_BG = 0, 3, 6, 9, 12


class Preintegration(NamedTuple):
    """Result of integrating one IMU window [t_i, t_j]."""

    delta_p: Tensor        # (3,)
    delta_q: Tensor        # (4,) wxyz
    delta_v: Tensor        # (3,)
    jacobian: Tensor       # (15, 15)
    covariance: Tensor     # (15, 15)
    sum_dt: Tensor         # ()
    linearized_ba: Tensor  # (3,)
    linearized_bg: Tensor  # (3,)
    sum_dt_buf: Tensor     # (S+1,) entry 0 is the identity start state
    delta_p_buf: Tensor    # (S+1, 3)
    delta_q_buf: Tensor    # (S+1, 4)
    delta_v_buf: Tensor    # (S+1, 3)
    n_samples: Tensor      # () int32 valid sample count


def associative_scan(fn: Callable,
                     elems: Sequence[Tensor]) -> Tuple[Tensor, ...]:
    """Inclusive scan of ``fn`` (associative, ``fn(earlier, later)``) over
    the leading axis of every tensor in ``elems``, in log depth: combine
    adjacent pairs, scan the half-length sequence, then fill in the even
    positions (the recursion of ``jax.lax.associative_scan``)."""
    elems = tuple(elems)
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        res = torch.empty_like(e)
        res[0:1] = e[0:1]
        res[2::2] = ev
        res[1::2] = od
        out.append(res)
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _noise_matrix(cfg: ImuConfig, device: torch.device) -> Tensor:
    """The 18x18 noise covariance, built once per config and device (a
    host-to-device copy inside a frame would synchronise)."""
    diag = [cfg.acc_n ** 2] * 3 + [cfg.gyr_n ** 2] * 3 + [cfg.acc_n ** 2] * 3 \
        + [cfg.gyr_n ** 2] * 3 + [cfg.acc_w ** 2] * 3 + [cfg.gyr_w ** 2] * 3
    return torch.diag(torch.tensor(diag, dtype=torch.float32, device=device))


def _fv_blocks(dt: Tensor, acc0: Tensor, gyr0: Tensor, acc1: Tensor,
               gyr1: Tensor, q0: Tensor, q1: Tensor, ba: Tensor, bg: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """The F (15x15) / V (15x18) blocks of midpoint intervals, batched over
    the leading dims of ``dt`` (...,) and the (..., 3|4) samples."""
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    R0 = quat_to_matrix(q0)
    R1 = quat_to_matrix(q1)
    w_x = skew(un_gyr)
    a0_x = skew(acc0 - ba)
    a1_x = skew(acc1 - ba)
    I3 = torch.eye(3, dtype=q0.dtype, device=q0.device)
    dt = dt[..., None, None]

    R1a1 = R1 @ a1_x
    Iw = I3 - w_x * dt
    lead = dt.shape[:-2]
    F = torch.zeros(lead + (15, 15), dtype=q0.dtype, device=q0.device)
    F[..., 0:3, 0:3] = I3
    F[..., 0:3, 3:6] = -0.25 * (R0 @ a0_x) * dt * dt \
        - 0.25 * R1a1 @ Iw * dt * dt
    F[..., 0:3, 6:9] = I3 * dt
    F[..., 0:3, 9:12] = -0.25 * (R0 + R1) * dt * dt
    F[..., 0:3, 12:15] = 0.25 * R1a1 * dt * dt * dt
    F[..., 3:6, 3:6] = Iw
    F[..., 3:6, 12:15] = -I3 * dt
    F[..., 6:9, 3:6] = -0.5 * (R0 @ a0_x) * dt - 0.5 * R1a1 @ Iw * dt
    F[..., 6:9, 6:9] = I3
    F[..., 6:9, 9:12] = -0.5 * (R0 + R1) * dt
    F[..., 6:9, 12:15] = 0.5 * R1a1 * dt * dt
    F[..., 9:12, 9:12] = I3
    F[..., 12:15, 12:15] = I3

    V = torch.zeros(lead + (15, 18), dtype=q0.dtype, device=q0.device)
    V[..., 0:3, 0:3] = 0.25 * R0 * dt * dt
    v03 = -0.125 * R1a1 * dt * dt * dt
    V[..., 0:3, 3:6] = v03
    V[..., 0:3, 6:9] = 0.25 * R1 * dt * dt
    V[..., 0:3, 9:12] = v03
    V[..., 3:6, 3:6] = 0.5 * I3 * dt
    V[..., 3:6, 9:12] = 0.5 * I3 * dt
    V[..., 6:9, 0:3] = 0.5 * R0 * dt
    v63 = -0.25 * R1a1 * dt * dt
    V[..., 6:9, 3:6] = v63
    V[..., 6:9, 6:9] = 0.5 * R1 * dt
    V[..., 6:9, 9:12] = v63
    V[..., 9:12, 12:15] = I3 * dt
    V[..., 12:15, 15:18] = I3 * dt
    return F, V


def _identity_quat(shape, like: Tensor) -> Tensor:
    q = torch.zeros(shape + (4,), dtype=like.dtype, device=like.device)
    q[..., 0] = 1.0
    return q


def midpoint_step(dt, acc0, gyr0, acc1, gyr1, delta_p, delta_q, delta_v,
                  ba, bg, jacobian, covariance, noise):
    """One midpoint-integration step: (delta_p', delta_q', delta_v',
    jacobian', covariance')."""
    un_acc_0 = quat_rotate(delta_q, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq_step = torch.cat([torch.ones_like(dt)[None], un_gyr * dt / 2.0])
    result_q = quat_normalize(quat_multiply(delta_q, dq_step))
    un_acc_1 = quat_rotate(result_q, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    result_p = delta_p + delta_v * dt + 0.5 * un_acc * dt * dt
    result_v = delta_v + un_acc * dt
    F, V = _fv_blocks(dt, acc0, gyr0, acc1, gyr1, delta_q, result_q, ba, bg)
    new_jac = F @ jacobian
    new_cov = F @ covariance @ F.T + V @ noise @ V.T
    return result_p, result_q, result_v, new_jac, new_cov


def preintegrate(dts: Tensor, accs: Tensor, gyrs: Tensor, valid: Tensor,
                 ba: Tensor, bg: Tensor, cfg: ImuConfig) -> Preintegration:
    """Integrate a padded window: dts (S,) seconds between samples (0 for
    padding), accs/gyrs (S, 3) readings at the END of each interval, valid
    (S,) bool, ba/bg (3,) linearisation biases. The first sample's reading
    also serves as the window's initial (acc0, gyr0)."""
    if cfg.preint_mode == "assoc":
        return preintegrate_assoc(dts, accs, gyrs, valid, ba, bg, cfg)
    dev = dts.device
    noise = _noise_matrix(cfg, dev)
    p = torch.zeros(3, device=dev)
    q = _identity_quat((), dts)
    v = torch.zeros(3, device=dev)
    jac = torch.eye(15, device=dev)
    cov = torch.zeros((15, 15), device=dev)
    sdt = torch.zeros((), device=dev)
    acc0, gyr0 = accs[0], gyrs[0]
    bufs = ([], [], [], [])
    for k in range(dts.shape[0]):
        ok = valid[k]
        dt = torch.where(ok, dts[k], torch.zeros_like(dts[k]))
        p2, q2, v2, jac2, cov2 = midpoint_step(
            dt, acc0, gyr0, accs[k], gyrs[k], p, q, v, ba, bg, jac, cov, noise)
        use = ok & (dt > 0)
        p, q, v = (torch.where(use, p2, p), torch.where(use, q2, q),
                   torch.where(use, v2, v))
        jac, cov = torch.where(use, jac2, jac), torch.where(use, cov2, cov)
        sdt = sdt + torch.where(use, dt, torch.zeros_like(dt))
        acc0 = torch.where(use, accs[k], acc0)
        gyr0 = torch.where(use, gyrs[k], gyr0)
        for buf, x in zip(bufs, (sdt, p, q, v)):
            buf.append(x)
    sdt_buf, p_buf, q_buf, v_buf = (torch.stack(b) for b in bufs)
    return Preintegration(
        delta_p=p, delta_q=q, delta_v=v, jacobian=jac, covariance=cov,
        sum_dt=sdt, linearized_ba=ba, linearized_bg=bg,
        sum_dt_buf=torch.cat([torch.zeros(1, device=dev), sdt_buf]),
        delta_p_buf=torch.cat([torch.zeros((1, 3), device=dev), p_buf]),
        delta_q_buf=torch.cat([_identity_quat((1,), dts), q_buf]),
        delta_v_buf=torch.cat([torch.zeros((1, 3), device=dev), v_buf]),
        n_samples=valid.sum(dtype=torch.int32))


def _combine_affine(a, b):
    """(F_b, W_b) o (F_a, W_a) = (F_b F_a, F_b W_a F_b^T + W_b)."""
    Fa, Wa = a
    Fb, Wb = b
    return (Fb @ Fa, Fb @ Wa @ Fb.transpose(-1, -2) + Wb)


def preintegrate_assoc(dts: Tensor, accs: Tensor, gyrs: Tensor,
                       valid: Tensor, ba: Tensor, bg: Tensor,
                       cfg: ImuConfig) -> Preintegration:
    """``preintegrate`` as log-depth scans: the interval rotations are
    state-independent, so delta_q is an associative quaternion prefix
    product; v and p are cumulative sums once the orientations are known;
    the Jacobian and covariance compose as affine maps (F, W). Padding and
    holes are identity elements; each interval starts at the previous
    valid sample."""
    S = dts.shape[0]
    dev = dts.device
    noise = _noise_matrix(cfg, dev)
    ok = valid & (dts > 0)
    dt = torch.where(ok, dts, torch.zeros_like(dts))

    iota = torch.arange(S, device=dev)
    prev = torch.cummax(torch.where(ok, iota, -1), dim=0).values
    prev = torch.cat([torch.full((1,), -1, device=dev, dtype=prev.dtype),
                      prev[:-1]])
    idx0 = torch.clamp(prev, min=0)
    acc0 = accs[idx0]
    gyr0 = gyrs[idx0]

    un_gyr = 0.5 * (gyr0 + gyrs) - bg
    dqs = torch.cat([torch.ones((S, 1), device=dev),
                     un_gyr * dt[:, None] / 2.0], dim=1)
    dqs = torch.where(ok[:, None], dqs, _identity_quat((1,), dts))
    q_pref, = associative_scan(
        lambda a, b: (quat_multiply(a[0], b[0]),), (dqs,))
    q_all = quat_normalize(q_pref)
    q_prev = torch.cat([_identity_quat((1,), dts), q_all[:-1]])

    un_acc0 = quat_rotate(q_prev, acc0 - ba)
    un_acc1 = quat_rotate(q_all, accs - ba)
    un_acc = torch.where(ok[:, None], 0.5 * (un_acc0 + un_acc1),
                         torch.zeros_like(un_acc0))
    dv = un_acc * dt[:, None]
    v_all = torch.cumsum(dv, dim=0)
    v_prev = torch.cat([torch.zeros((1, 3), device=dev), v_all[:-1]])
    dp = v_prev * dt[:, None] + 0.5 * un_acc * dt[:, None] ** 2
    p_all = torch.cumsum(dp, dim=0)
    sdt_buf = torch.cumsum(dt, dim=0)

    F, V = _fv_blocks(dt, acc0, gyr0, accs, gyrs, q_prev, q_all, ba, bg)
    I15 = torch.eye(15, device=dev)
    F = torch.where(ok[:, None, None], F, I15)
    W = V @ noise @ V.transpose(-1, -2)
    W = torch.where(ok[:, None, None], W, torch.zeros_like(W))
    Fp, Wp = associative_scan(_combine_affine, (F, W))

    return Preintegration(
        delta_p=p_all[-1], delta_q=q_all[-1], delta_v=v_all[-1],
        jacobian=Fp[-1], covariance=Wp[-1], sum_dt=sdt_buf[-1],
        linearized_ba=ba, linearized_bg=bg,
        sum_dt_buf=torch.cat([torch.zeros(1, device=dev), sdt_buf]),
        delta_p_buf=torch.cat([torch.zeros((1, 3), device=dev), p_all]),
        delta_q_buf=torch.cat([_identity_quat((1,), dts), q_all]),
        delta_v_buf=torch.cat([torch.zeros((1, 3), device=dev), v_all]),
        n_samples=valid.sum(dtype=torch.int32))


def bias_blocks(pre: Preintegration):
    """(dp/dba, dp/dbg, dq/dbg, dv/dba, dv/dbg) blocks of the Jacobian."""
    J = pre.jacobian
    return tuple(J[..., r:r + 3, c:c + 3] for r, c in
                 ((O_P, O_BA), (O_P, O_BG), (O_R, O_BG), (O_V, O_BA),
                  (O_V, O_BG)))


def matvec(m: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product."""
    return (m @ v[..., None])[..., 0]


def corrected_deltas(pre: Preintegration, ba_i: Tensor, bg_i: Tensor):
    """First-order bias-corrected (delta_p, delta_q, delta_v)."""
    dp_dba, dp_dbg, dq_dbg, dv_dba, dv_dbg = bias_blocks(pre)
    dba = ba_i - pre.linearized_ba
    dbg = bg_i - pre.linearized_bg
    corrected_q = quat_multiply(pre.delta_q, quat_exp(matvec(dq_dbg, dbg)))
    corrected_v = pre.delta_v + matvec(dv_dba, dba) + matvec(dv_dbg, dbg)
    corrected_p = pre.delta_p + matvec(dp_dba, dba) + matvec(dp_dbg, dbg)
    return corrected_p, corrected_q, corrected_v


def evaluate_residual(pre: Preintegration, p_i, q_i, v_i, ba_i, bg_i,
                      p_j, q_j, v_j, ba_j, bg_j, gravity) -> Tensor:
    """15-dim preintegration residual with first-order bias correction."""
    corrected_p, corrected_q, corrected_v = corrected_deltas(pre, ba_i, bg_i)
    qi_inv = quat_conjugate(q_i)
    sdt = pre.sum_dt[..., None]
    r_p = quat_rotate(qi_inv, 0.5 * gravity * sdt * sdt + p_j - p_i
                      - v_i * sdt) - corrected_p
    r_q = 2.0 * quat_multiply(quat_conjugate(corrected_q),
                              quat_multiply(qi_inv, q_j))[..., 1:4]
    r_v = quat_rotate(qi_inv, gravity * sdt + v_j - v_i) - corrected_v
    return torch.cat([r_p, r_q, r_v, ba_j - ba_i, bg_j - bg_i], dim=-1)


def sqrt_information(pre: Preintegration, scale: float = 0.001) -> Tensor:
    """Whitening matrix scale * chol(cov^-1)^T, batched over leading dims.
    A failed inverse or factorisation gives zeros, as the reference's
    non-finite entries do; nothing raises or synchronises."""
    eye = torch.eye(15, device=pre.covariance.device)
    info, _ = torch.linalg.inv_ex(pre.covariance + 1e-10 * eye)
    L, err = torch.linalg.cholesky_ex(info)
    L = torch.where((err == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    sqrt_info = scale * L.transpose(-1, -2)
    return torch.where(torch.isfinite(sqrt_info), sqrt_info,
                       torch.zeros_like(sqrt_info))


def interpolate_delta(pre: Preintegration, dt: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-point (delta_p (N, 3), delta_q (N, 4)) at relative times dt (N,):
    binary search into sum_dt_buf, slerp rotations, lerp translations."""
    last = pre.n_samples.long()[None]            # (1,): indexing stays on device
    hi = pre.sum_dt_buf[last]
    dt = torch.minimum(torch.clamp(dt, min=0.0), hi)
    idx = torch.searchsorted(pre.sum_dt_buf, dt, right=True) - 1
    idx = torch.minimum(torch.clamp(idx, min=0), last - 1)
    t0 = pre.sum_dt_buf[idx]
    t1 = pre.sum_dt_buf[idx + 1]
    s = (dt - t0) / torch.clamp(t1 - t0, min=1e-9)
    s = torch.clamp(s, 0.0, 1.0)
    p = (1.0 - s)[:, None] * pre.delta_p_buf[idx] \
        + s[:, None] * pre.delta_p_buf[idx + 1]
    q = quat_slerp(pre.delta_q_buf[idx], pre.delta_q_buf[idx + 1], s[:, None])
    return p, q
