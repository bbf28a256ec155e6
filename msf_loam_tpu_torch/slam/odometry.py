"""Scan-to-scan odometry (port of the JAX package's ``slam/odometry.py``,
kernel branches, no deskew).

Edges: nearest less-sharp point a and the nearest point b on a different
nearby ring, from one ``odo_corr`` launch (K=0). Planes: a structured
support of a + 2 nearest same-ring + the nearest different-ring point +
4 nearest nearby-ring points (K=16 candidate bins from one ``odo_corr``
launch), fitted by one ``select_fit`` launch in ``plane`` mode. Two
re-association rounds around a 6-iteration Gauss-Newton.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from msf_loam_tpu_torch.config import OdometryConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose, cross, select_pose
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.ops.odo_corr import odo_corr
from msf_loam_tpu_torch.ops.select_fit import select_fit

Tensor = torch.Tensor


class EdgeCorrespondences(NamedTuple):
    points: Tensor
    line_c: Tensor
    line_n: Tensor
    valid: Tensor


class PlaneCorrespondences(NamedTuple):
    points: Tensor
    plane_c: Tensor
    plane_n: Tensor
    valid: Tensor


def _rows(x: Tensor, idx: Tensor) -> Tensor:
    """x[idx] with indices clamped into range (JAX gather semantics)."""
    return x[torch.clamp(idx.long(), 0, x.shape[0] - 1)]


def _norm3(v: Tensor) -> Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def find_edge_correspondences(query: PointBatch, ref: PointBatch, pose: Pose,
                              cfg: OdometryConfig,
                              gate_scale: float = 1.0) -> EdgeCorrespondences:
    q_world = pose.apply(query.xyz)
    oc = odo_corr(q_world, ref.masked_xyz(), ref.mask, ref.ring, K=0,
                  nearby=cfg.nearby_scan)
    a_ok = (oc.a_d2 < cfg.dist_sq_threshold) & query.mask
    b_ok = oc.c_d2 < cfg.dist_sq_threshold
    a_xyz = _rows(ref.xyz, oc.a_idx)
    b_xyz = _rows(ref.xyz, oc.c_idx)
    direction = a_xyz - b_xyz
    nrm = _norm3(direction)[:, None]
    line_n = direction / torch.clamp(nrm, min=1e-12)
    valid = a_ok & b_ok & (nrm[:, 0] > 1e-6)
    if cfg.corr_max_resid > 0:
        d_line = _norm3(cross(line_n, q_world - a_xyz))
        valid = valid & (d_line < gate_scale * cfg.corr_max_resid)
    return EdgeCorrespondences(query.xyz, a_xyz, line_n, valid)


def _pick(mask: Tensor, cand_d2: Tensor, cand_idx: Tensor, k: int):
    """The k smallest masked candidate distances (ties to the lower bin,
    as lax.top_k): their indices and validity."""
    neg_inf = torch.full((), float("-inf"), device=cand_d2.device)
    score = torch.where(mask, -cand_d2, neg_inf)
    pos = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    vals = torch.gather(score, 1, pos)
    return torch.gather(cand_idx, 1, pos), vals > float("-inf")


def find_plane_correspondences_fit(query: PointBatch, ref: PointBatch,
                                   pose: Pose, cfg: OdometryConfig,
                                   gate_scale: float = 1.0
                                   ) -> PlaneCorrespondences:
    """Plane correspondence from an 8-point structured support and a TLS
    fit with the planarity gate."""
    q_world = pose.apply(query.xyz)
    K = 16
    oc = odo_corr(q_world, ref.masked_xyz(), ref.mask, ref.ring, K=K,
                  nearby=cfg.nearby_scan)
    a_sel = oc.a_idx
    a_ok = (oc.a_d2 < cfg.dist_sq_threshold) & query.mask
    ring_a = oc.a_ring
    c_ok = oc.c_d2 < cfg.dist_sq_threshold
    cand_ok = oc.cand_d2 < cfg.dist_sq_threshold
    is_a = oc.cand_idx == a_sel[:, None]
    same_c = (oc.cand_ring == ring_a[:, None]) & ~is_a & cand_ok
    drc = (oc.cand_ring - ring_a[:, None]).abs().float()
    near_c = (drc <= cfg.nearby_scan) & cand_ok

    b_idx, b_ok = _pick(same_c, oc.cand_d2, oc.cand_idx, 2)
    sup_idx = [a_sel[:, None], b_idx, oc.c_idx[:, None]]
    sup_ok = [a_ok[:, None], b_ok, c_ok[:, None]]
    if cfg.plane_support_extra > 0:
        e_idx, e_ok = _pick(near_c, oc.cand_d2, oc.cand_idx,
                            cfg.plane_support_extra)
        sup_idx.append(e_idx)
        sup_ok.append(e_ok)
    sup_idx = torch.cat(sup_idx, dim=1)
    sup_ok = torch.cat(sup_ok, dim=1)

    S = sup_idx.shape[1]
    neighbors = _rows(ref.xyz, sup_idx.reshape(-1)).reshape(-1, S, 3)
    cand = torch.where(sup_ok[:, :, None], neighbors,
                       torch.full((), 1e9, device=neighbors.device))
    # radius 1e17 keeps every real support and rejects the 1e9 sentinels;
    # min_count = S is the all-slots-valid gate
    fit = select_fit(cand.permute(2, 0, 1).contiguous(),
                     q_world.contiguous(), 1e17, 1e17, k=S, mode="plane",
                     min_count=S, tol=cfg.plane_fit_tol)
    valid = a_ok & fit.valid
    if cfg.corr_max_resid > 0:
        resid = (fit.normal * (q_world - fit.center)).sum(dim=-1).abs()
        valid = valid & (resid < gate_scale * cfg.corr_max_resid)
    return PlaneCorrespondences(query.xyz, fit.center, fit.normal, valid)


class OdometryResult(NamedTuple):
    pose_curr2last: Pose
    n_correspondences: Tensor  # ()
    ok: Tensor                 # () bool
    cost: Tensor


def match_scan2scan(scan_last: ScanFeatures, scan_curr: ScanFeatures,
                    pose0: Pose, cfg: OdometryConfig) -> OdometryResult:
    """Estimate pose_curr2last by matching curr's sharp/flat features
    against last's less-sharp/less-flat clouds."""
    return match_clouds(scan_last.corner_less_sharp, scan_last.surf_less_flat,
                        scan_curr.corner_sharp, scan_curr.surf_flat, pose0, cfg)


def match_clouds(ref_corner: PointBatch, ref_surf: PointBatch,
                 q_corner: PointBatch, q_surf: PointBatch, pose0: Pose,
                 cfg: OdometryConfig) -> OdometryResult:
    """Scan-to-scan matcher core over explicit feature clouds."""
    pose = pose0
    n_corr = cost = None
    for rnd in range(cfg.outer_rounds):
        gate_scale = cfg.corr_gate_relax if rnd < cfg.outer_rounds - 1 else 1.0
        edges = find_edge_correspondences(q_corner, ref_corner, pose, cfg,
                                          gate_scale)
        planes = find_plane_correspondences_fit(q_surf, ref_surf, pose, cfg,
                                                gate_scale)
        n_corr = edges.valid.float().sum() + planes.valid.float().sum()

        def build(p, v, edges=edges, planes=planes):
            eb = icp.edge_residuals(p, edges.points, edges.line_c,
                                    edges.line_n, edges.valid)
            pb = icp.plane_residuals(p, planes.points, planes.plane_c,
                                     planes.plane_n, planes.valid)
            return [eb, pb], [gn.huber_weights(eb, cfg.huber_delta),
                              gn.huber_weights(pb, cfg.huber_delta)]

        out = gn.gauss_newton(build, pose, torch.zeros_like(pose.t),
                              n_iters=cfg.gn_iterations)
        pose = select_pose(n_corr >= cfg.min_correspondences, out.pose, pose)
        cost = out.cost
    return OdometryResult(pose_curr2last=pose, n_correspondences=n_corr,
                          ok=n_corr >= cfg.min_correspondences, cost=cost)
