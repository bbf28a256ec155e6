"""GPS / odometry / loop-closure pose-graph fusion (port of the JAX
package's ``slam/posegraph.py``).

The factors of the reference's ``GpsFusion``:

* ``RelativePoseFactor`` between consecutive keyframes: residual = the
  quaternion vector part and translation of (measured relative pose vs
  current relative pose), translation / 0.1, rotation / 0.01;
* ``GpsFactor``: a time-interpolated translation tie between the two
  poses bracketing each GPS fix, / 0.01;
* loop factors: ``RelativePoseFactor`` between non-consecutive keyframes.

The chain factors make the Gauss-Newton Hessian block-tridiagonal; it is
assembled with batched products (GPS and loop terms through one-hot
matmuls, never ``index_add_``, whose CUDA atomics sum in a run-dependent
order) and solved exactly by the block-Thomas kernel
(``ops.block_tridiag``). Loops add a low-rank term handled exactly by a
Woodbury correction, both right-hand-side groups in one kernel launch.
Jacobians are exact (``torch.func.jacrev`` under ``torch.func.vmap``).
Every product runs in float32 (the package turns TF32 off): the normal
equations are far too ill-conditioned for reduced precision.

Everything runs on the device of the poses given; no function here
synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as nnf

from msf_loam_tpu_torch.config import PoseGraphConfig
from msf_loam_tpu_torch.core.se3 import (Pose, quat_conjugate, quat_multiply,
                                         quat_normalize, quat_rotate)
from msf_loam_tpu_torch.ops.block_tridiag import block_tridiag

Tensor = torch.Tensor


def _t(a, dtype, device) -> Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class LoopFactors(NamedTuple):
    """Static-shape loop-closure constraints (padded; invalid rows inert)."""

    idx_i: Tensor    # (L,) int64 keyframe index i
    idx_j: Tensor    # (L,) int64 keyframe index j (> i)
    meas: Pose       # (L,) measured relative pose i->j
    valid: Tensor    # (L,) bool

    @staticmethod
    def pad(idx_i, idx_j, meas: Pose, to_l: int) -> "LoopFactors":
        """Pad ``l`` loops (index arrays of any kind, ``meas`` on the
        device the factors go to) to ``to_l`` rows."""
        dev = meas.t.device
        l = int(np.asarray(idx_i).shape[0])
        if to_l < l:
            raise ValueError(f"cannot pad {l} loops to {to_l}")
        p = to_l - l
        ident = Pose.identity(dev, batch_shape=(p,))
        return LoopFactors(
            idx_i=torch.cat([_t(idx_i, torch.int64, dev),
                             torch.zeros(p, dtype=torch.int64, device=dev)]),
            idx_j=torch.cat([_t(idx_j, torch.int64, dev),
                             torch.ones(p, dtype=torch.int64, device=dev)]),
            meas=Pose(t=torch.cat([meas.t.float(), ident.t]),
                      q=torch.cat([meas.q.float(), ident.q])),
            valid=torch.cat([torch.ones(l, dtype=torch.bool, device=dev),
                             torch.zeros(p, dtype=torch.bool, device=dev)]))


class PoseGraphData(NamedTuple):
    """Static-shape problem data."""

    times: Tensor        # (N,) keyframe times
    rel_meas: Pose       # (N-1,) measured relative poses (from odometry)
    rel_valid: Tensor    # (N-1,) bool
    gps_xyz: Tensor      # (M, 3) fixed points
    gps_seg: Tensor      # (M,) int64 index i of the bracketing pair (i, i+1)
    gps_frac: Tensor     # (M,) interpolation fraction in [0, 1]
    gps_valid: Tensor    # (M,) bool


class PoseGraphResult(NamedTuple):
    poses: Pose
    initial_cost: Tensor
    final_cost: Tensor


def build_graph_data(times: Tensor, poses: Pose, gps_times: Tensor,
                     gps_xyz: Tensor, gps_valid: Tensor) -> PoseGraphData:
    """Measured relative poses from the trajectory, and each GPS fix's
    bracketing keyframe pair with its interpolation fraction."""
    inv_q = quat_conjugate(poses.q[:-1])
    rel_t = quat_rotate(inv_q, poses.t[1:] - poses.t[:-1])
    rel_q = quat_normalize(quat_multiply(inv_q, poses.q[1:]))
    n = times.shape[0]
    seg = torch.clamp(torch.searchsorted(times, gps_times, right=True) - 1,
                      0, n - 2)
    t0 = times[seg]
    t1 = times[seg + 1]
    frac = torch.clamp((gps_times - t0) / torch.clamp(t1 - t0, min=1e-9),
                       0.0, 1.0)
    in_range = (gps_times >= times[0]) & (gps_times <= times[-1])
    return PoseGraphData(
        times=times, rel_meas=Pose(t=rel_t, q=rel_q),
        rel_valid=torch.ones(n - 1, dtype=torch.bool, device=times.device),
        gps_xyz=gps_xyz, gps_seg=seg, gps_frac=frac,
        gps_valid=gps_valid & in_range)


# ---------------------------------------------------------------------------
# factor residuals (per pair; batched over leading dims) and their Jacobians
# ---------------------------------------------------------------------------


def _recip(x: float) -> float:
    """The float32 reciprocal the compiled reference multiplies by where
    it divides by a constant."""
    return float(np.float32(1.0) / np.float32(x))


def _rel_residual(delta_i: Tensor, delta_j: Tensor, pose_i: Pose,
                  pose_j: Pose, meas: Pose, sr: float, st: float) -> Tensor:
    """RelativePoseFactor residual at retracted poses."""
    pi = pose_i.retract(delta_i)
    pj = pose_j.retract(delta_j)
    res = pi.inverse().compose(pj).inverse().compose(meas)
    return torch.cat([res.t * _recip(st), res.q[..., 1:4] * _recip(sr)],
                     dim=-1)


def _gps_residual(delta_i: Tensor, delta_j: Tensor, pose_i: Pose,
                  pose_j: Pose, gps: Tensor, frac: Tensor,
                  st: float) -> Tensor:
    """GpsFactor residual at retracted poses."""
    ti = pose_i.t + delta_i[..., 0:3]
    tj = pose_j.t + delta_j[..., 0:3]
    f = frac[..., None]
    t = (1.0 - f) * ti + f * tj
    return (t - gps) * _recip(st)


def _linearized(fn):
    """vmap'd (value, (dr/d delta_i, dr/d delta_j)) of a pair residual."""
    def with_value(*args):
        r = fn(*args)
        return r, r
    jac = torch.func.vmap(torch.func.jacrev(with_value, argnums=(0, 1),
                                            has_aux=True))

    def run(*args):
        (Ji, Jj), r = jac(*args)
        return r, Ji, Jj
    return run


def _make_factor_fns(cfg: PoseGraphConfig):
    """(rel value, rel linearization, gps value, gps linearization)."""
    def rel_fn(di, dj, pi, pj, meas):
        return _rel_residual(di, dj, pi, pj, meas, cfg.rel_sigma_r,
                             cfg.rel_sigma_t)

    def gps_fn(di, dj, pi, pj, g, f):
        return _gps_residual(di, dj, pi, pj, g, f, cfg.gps_sigma_t)
    return rel_fn, _linearized(rel_fn), gps_fn, _linearized(gps_fn)


def _huber_w(r: Tensor, delta: float) -> Tensor:
    nrm = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-30)
    return torch.clamp(torch.full_like(nrm, delta) / nrm, max=1.0)


def _take(poses: Pose, idx) -> Pose:
    return Pose(poses.t[idx], poses.q[idx])


def _pairs(poses: Pose):
    return Pose(poses.t[:-1], poses.q[:-1]), Pose(poses.t[1:], poses.q[1:])


def _chain_cost(poses: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                rel_val, gps_val) -> Tensor:
    N = poses.t.shape[0]
    pi, pj = _pairs(poses)
    z = poses.t.new_zeros((N - 1, 6))
    r_rel = rel_val(z, z, pi, pj, data.rel_meas)
    w_rel = _huber_w(r_rel, cfg.huber_delta) * data.rel_valid
    cost = torch.sum(w_rel * torch.sum(r_rel ** 2, -1))
    M = data.gps_xyz.shape[0]
    if M:
        zg = poses.t.new_zeros((M, 6))
        r_gps = gps_val(zg, zg, _take(poses, data.gps_seg),
                        _take(poses, data.gps_seg + 1), data.gps_xyz,
                        data.gps_frac)
        w_gps = _huber_w(r_gps, cfg.huber_delta) * data.gps_valid
        cost = cost + torch.sum(w_gps * torch.sum(r_gps ** 2, -1))
    return cost


def _outer(wA: Tensor, B: Tensor) -> Tensor:
    return torch.einsum("nri,nrj->nij", wA, B)


def _assemble_chain(poses: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                    rel_lin, gps_lin):
    """Weighted GN normal equations of the chain and GPS factors as
    block-tridiagonal (D (N,6,6), U (N-1,6,6), rhs b (N,6)), LM-damped.
    Chain terms land by static pads, GPS terms by one-hot matmuls."""
    N = poses.t.shape[0]
    pi, pj = _pairs(poses)
    z = poses.t.new_zeros((N - 1, 6))
    r_rel, Ji, Jj = rel_lin(z, z, pi, pj, data.rel_meas)
    w_rel = _huber_w(r_rel, cfg.huber_delta) * data.rel_valid
    wJi = Ji * w_rel[:, None, None]
    wJj = Jj * w_rel[:, None, None]

    def pad_tail(x):
        return torch.cat([x, 0.0 * x[:1]], dim=0)

    def pad_head(x):
        return torch.cat([0.0 * x[:1], x], dim=0)
    D = pad_tail(_outer(wJi, Ji)) + pad_head(_outer(wJj, Jj))
    U = _outer(wJi, Jj)              # U[i] couples pose i and i+1
    b = pad_tail(torch.einsum("nri,nr->ni", wJi, r_rel)) \
        + pad_head(torch.einsum("nri,nr->ni", wJj, r_rel))

    M = data.gps_xyz.shape[0]
    if M:
        zg = poses.t.new_zeros((M, 6))
        s = data.gps_seg
        r_gps, Gi, Gj = gps_lin(zg, zg, _take(poses, s), _take(poses, s + 1),
                                data.gps_xyz, data.gps_frac)
        w_gps = _huber_w(r_gps, cfg.huber_delta) * data.gps_valid
        wGi = Gi * w_gps[:, None, None]
        wGj = Gj * w_gps[:, None, None]
        oh = nnf.one_hot(s, N).float()              # (M, N)
        oh1 = nnf.one_hot(s + 1, N).float()
        ohU = nnf.one_hot(s, N - 1).float()
        D = D + torch.einsum("mn,mij->nij", oh, _outer(wGi, Gi))
        D = D + torch.einsum("mn,mij->nij", oh1, _outer(wGj, Gj))
        U = U + torch.einsum("mn,mij->nij", ohU, _outer(wGi, Gj))
        b = b + torch.einsum("mn,mi->ni", oh,
                             torch.einsum("mri,mr->mi", wGi, r_gps))
        b = b + torch.einsum("mn,mi->ni", oh1,
                             torch.einsum("mri,mr->mi", wGj, r_gps))

    # LM damping (also fixes the global gauge the GPS ties leave free)
    eye = torch.eye(6, device=D.device)
    trace = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)
    D = D + 1e-4 * eye[None] + 1e-6 * trace[:, None, None] * eye[None]
    return D, U, b


def optimize(poses0: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
             n_iters: int = 10) -> PoseGraphResult:
    """Batch pose-graph GN (chain + GPS) with the exact block-tridiagonal
    solve: one kernel launch per iteration on the card."""
    return _optimize_impl(poses0, data, cfg, n_iters, solve_block_tridiag)


def optimize_distributed(mesh, poses0: Pose, data: PoseGraphData,
                         cfg: PoseGraphConfig, n_iters: int = 10
                         ) -> PoseGraphResult:
    """``optimize`` with the block-tridiagonal solve distributed over the
    mesh ``data`` axis (``parallel.distributed_ba``: condense, gathered
    separator solve, back-substitute; three launches and two all-gathers
    an iteration). Assembly and retraction run replicated. N must divide
    by the axis into chunks of at least 2 (``pad_graph`` /
    ``next_bucket``)."""
    from msf_loam_tpu_torch.parallel.distributed_ba import \
        distributed_tridiag_solve
    return _optimize_impl(
        poses0, data, cfg, n_iters,
        lambda D, U, b: distributed_tridiag_solve(mesh, D, U, b))


def _optimize_impl(poses0: Pose, data: PoseGraphData, cfg: PoseGraphConfig,
                   n_iters: int, solver) -> PoseGraphResult:
    rel_val, rel_lin, gps_val, gps_lin = _make_factor_fns(cfg)
    initial = _chain_cost(poses0, data, cfg, rel_val, gps_val)
    poses = poses0
    for _ in range(n_iters):
        D, U, b = _assemble_chain(poses, data, cfg, rel_lin, gps_lin)
        dx = solver(D, U, -b)
        poses = poses.retract(dx)
    final = _chain_cost(poses, data, cfg, rel_val, gps_val)
    return PoseGraphResult(poses=poses, initial_cost=initial,
                           final_cost=final)


def _loop_terms(poses: Pose, loops: LoopFactors, cfg: PoseGraphConfig,
                rel_lin):
    L = loops.idx_i.shape[0]
    zl = poses.t.new_zeros((L, 6))
    r, Li, Lj = rel_lin(zl, zl, _take(poses, loops.idx_i),
                        _take(poses, loops.idx_j), loops.meas)
    w = _huber_w(r, cfg.huber_delta) * loops.valid
    return r, Li, Lj, w


def _assemble_loops(poses: Pose, loops: LoopFactors, cfg: PoseGraphConfig,
                    b: Tensor, rel_lin):
    """The loop factors' gradient added to ``b``, and W (N, 6, 6L): column
    block l holds sqrt(w_l)·J_lᵀ at rows i_l and j_l, so that the
    Hessian is T + W Wᵀ. One-hot matmuls; padded loops have w = 0, so
    their one-hot rows and W columns contribute nothing."""
    N = poses.t.shape[0]
    L = loops.idx_i.shape[0]
    r, Li, Lj, w = _loop_terms(poses, loops, cfg, rel_lin)
    oh_i = nnf.one_hot(loops.idx_i, N).float()     # (L, N)
    oh_j = nnf.one_hot(loops.idx_j, N).float()
    wLi = Li * w[:, None, None]
    wLj = Lj * w[:, None, None]
    b = b + torch.einsum("ln,li->ni", oh_i,
                         torch.einsum("lri,lr->li", wLi, r))
    b = b + torch.einsum("ln,li->ni", oh_j,
                         torch.einsum("lri,lr->li", wLj, r))
    sq = torch.sqrt(w)[:, None, None]
    Wi = torch.transpose(Li * sq, 1, 2)            # (L, 6 state, 6 res)
    Wj = torch.transpose(Lj * sq, 1, 2)
    W = (torch.einsum("ln,lam->nalm", oh_i, Wi)
         + torch.einsum("ln,lam->nalm", oh_j, Wj)).reshape(N, 6, 6 * L)
    return b, W


def _capacitance_correction(W: Tensor, X: Tensor) -> Tensor:
    """x = y - Z S⁻¹ Wᵀ y from X = [y | Z] = T⁻¹ [rhs | W], with
    S = I + Wᵀ Z (6L x 6L, dense; ``solve_ex`` does not synchronise)."""
    m = W.shape[-1]
    y, Z = X[..., 0], X[..., 1:]
    S = torch.eye(m, device=W.device) + torch.einsum("nim,nik->mk", W, Z)
    Wty = torch.einsum("nim,ni->m", W, y)
    sol = torch.linalg.solve_ex(S, Wty)[0]
    return y - torch.einsum("nim,m->ni", Z, sol)


def _woodbury_solve(D: Tensor, U: Tensor, rhs: Tensor, W: Tensor) -> Tensor:
    """(T + W Wᵀ)⁻¹ rhs: y = T⁻¹ rhs and Z = T⁻¹ W from one block-Thomas
    launch over the columns [rhs | W], then the capacitance correction."""
    X = solve_block_tridiag_multi(D, U, torch.cat([rhs[..., None], W], -1))
    return _capacitance_correction(W, X)


def optimize_with_loops(poses0: Pose, data: PoseGraphData, loops: LoopFactors,
                        cfg: PoseGraphConfig, n_iters: int = 10
                        ) -> PoseGraphResult:
    """Pose-graph GN with chain + GPS + loop-closure factors, solved
    exactly: H = T + W Wᵀ, T the chain's block-tridiagonal part, W the
    weighted loop Jacobians (6N x 6L, nonzero only at rows i and j of each
    loop), through the Woodbury identity. One kernel launch per iteration
    on the card. Invalid (padded) loops are inert."""
    return _optimize_loops_impl(poses0, data, loops, cfg, n_iters,
                                _woodbury_solve)


def optimize_with_loops_distributed(mesh, poses0: Pose, data: PoseGraphData,
                                    loops: LoopFactors, cfg: PoseGraphConfig,
                                    n_iters: int = 10) -> PoseGraphResult:
    """``optimize_with_loops`` with the whole Woodbury solve distributed
    over the mesh ``data`` axis (``parallel.distributed_ba.
    distributed_woodbury_solve``: three launches, two all-gathers and one
    all-reduce an iteration). N as ``optimize_distributed``."""
    from msf_loam_tpu_torch.parallel.distributed_ba import \
        distributed_woodbury_solve
    return _optimize_loops_impl(
        poses0, data, loops, cfg, n_iters,
        lambda D, U, rhs, W: distributed_woodbury_solve(mesh, D, U, rhs, W))


def _optimize_loops_impl(poses0: Pose, data: PoseGraphData,
                         loops: LoopFactors, cfg: PoseGraphConfig,
                         n_iters: int, woodbury_solver) -> PoseGraphResult:
    if loops.idx_i.shape[0] == 0:
        raise ValueError("pad loops to at least 1 slot (LoopFactors.pad); "
                         "invalid slots are inert")
    rel_val, rel_lin, gps_val, gps_lin = _make_factor_fns(cfg)

    def total_cost(poses):
        r, _, _, w = _loop_terms(poses, loops, cfg, rel_lin)
        chain = _chain_cost(poses, data, cfg, rel_val, gps_val)
        return chain + torch.sum(w * torch.sum(r * r, -1))

    initial = total_cost(poses0)
    poses = poses0
    for _ in range(n_iters):
        D, U, b = _assemble_chain(poses, data, cfg, rel_lin, gps_lin)
        b, W = _assemble_loops(poses, loops, cfg, b, rel_lin)
        dx = woodbury_solver(D, U, -b, W)
        poses = poses.retract(dx)
    final = total_cost(poses)
    return PoseGraphResult(poses=poses, initial_cost=initial,
                           final_cost=final)


def pad_graph(poses: Pose, data: PoseGraphData, to_n: int
              ) -> Tuple[Pose, PoseGraphData]:
    """Pad a graph to ``to_n`` poses (a size class). Padding poses chain to
    the last real pose with identity relative measurements and
    rel_valid=True: they stay glued to it and never move a real pose (no
    GPS tie lands on them)."""
    n = poses.t.shape[0]
    if to_n < n:
        raise ValueError(f"cannot pad a graph of {n} poses to {to_n}")
    pad = to_n - n
    if pad == 0:
        return poses, data
    dev = poses.t.device
    poses_p = Pose(t=torch.cat([poses.t, poses.t[-1:].expand(pad, 3)]),
                   q=torch.cat([poses.q, poses.q[-1:].expand(pad, 4)]))
    times_p = torch.cat([data.times, data.times[-1] + 1.0 * (
        1.0 + torch.arange(pad, dtype=data.times.dtype, device=dev))])
    rel_pad = Pose.identity(dev, batch_shape=(pad,))
    rel_meas_p = Pose(t=torch.cat([data.rel_meas.t, rel_pad.t]),
                      q=torch.cat([data.rel_meas.q, rel_pad.q]))
    rel_valid_p = torch.cat([data.rel_valid,
                             torch.ones(pad, dtype=torch.bool, device=dev)])
    return poses_p, data._replace(times=times_p, rel_meas=rel_meas_p,
                                  rel_valid=rel_valid_p)


def next_bucket(n: int, buckets=(64, 128, 256, 512, 1024, 2048, 4096, 8192)
                ) -> int:
    """Smallest standard size class >= n."""
    for b in buckets:
        if b >= n:
            return b
    return n


def solve_block_tridiag(D: Tensor, U: Tensor, b: Tensor) -> Tensor:
    """x (N, 6) with tridiag(Uᵀ, D, U) x = b (one kernel launch on the
    card)."""
    return block_tridiag(D, U, b[..., None])[..., 0]


def solve_block_tridiag_multi(D: Tensor, U: Tensor, B: Tensor) -> Tensor:
    """X (N, 6, m) with tridiag(Uᵀ, D, U) X = B, one factorisation shared
    by all m columns (one kernel launch on the card)."""
    return block_tridiag(D, U, B)
