"""Scan-to-map registration against the voxel hash maps (port of the JAX
package's ``slam/mapping.py`` on its cached fused-selection branch): the
loosely-coupled matcher ``match_scan2map_core`` (``match_scan2map``
without query groups) and the IMU-coupled
``match_scan2map_deskew_core`` / ``match_scan2map_tight_core``.

The 8-cell octant candidates of both feature clouds are gathered once per
frame: with query groups (the fused frames' grouped downsample) by the
two-level grouped gather in rows layout, without them by the one-level
gather in planar (3, Q, 8P) layout. Every re-association round re-runs
only the fused selection + fit kernel, one launch for both maps
(``ops.select_fit.select_fit_pair``): ``line`` for corners, ``plane2`` (or
``plane``) for surfaces, then a 6-iteration Gauss-Newton.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from msf_loam_tpu_torch.config import MappingConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch
from msf_loam_tpu_torch.core.se3 import Pose, select_pose
from msf_loam_tpu_torch.imu import imu_factor as imu_factor_mod
from msf_loam_tpu_torch.imu.preintegration import sqrt_information
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.ops.select_fit import select_fit_pair
from msf_loam_tpu_torch.slam import voxel_map as vm

Tensor = torch.Tensor


class MapCorrespondences(NamedTuple):
    edge_points: Tensor
    edge_c: Tensor
    edge_n: Tensor
    edge_valid: Tensor
    plane_points: Tensor
    plane_c: Tensor
    plane_n: Tensor
    plane_valid: Tensor


def _sq_f32(x: float) -> float:
    """x**2 rounded as float32 arithmetic rounds it (the JAX radii are
    float32 scalars)."""
    x = np.float32(x)
    return float(x * x)


class _CandidateCache:
    """Per-frame octant candidates of both maps; each re-association round
    runs only the fused selection + fit kernel, one launch for both. The
    queries may carry a leading lane axis (the batched pipeline's B*Q
    candidate rows, lane-major): the launch then covers every lane."""

    def __init__(self, candp_c: Tensor, candp_s: Tensor, cell_c: float,
                 cell_s: float):
        self.candp_c, self.candp_s = candp_c, candp_s
        self.cell_c, self.cell_s = cell_c, cell_s

    @classmethod
    def gather(cls, corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
               cw0: Tensor, sw0: Tensor,
               corner_groups: Optional[vm.QueryGroups],
               surf_groups: Optional[vm.QueryGroups]) -> "_CandidateCache":
        if corner_groups is not None and surf_groups is not None:
            candp_c = vm.gather_candidates_rows_grouped(
                corner_map, cw0, corner_groups.gid, corner_groups.rep_pos)
            candp_s = vm.gather_candidates_rows_grouped(
                surf_map, sw0, surf_groups.gid, surf_groups.rep_pos)
        else:
            candp_c = vm.gather_candidates_planar(corner_map, cw0)
            candp_s = vm.gather_candidates_planar(surf_map, sw0)
        return cls(candp_c, candp_s, corner_map.cell_size, surf_map.cell_size)

    def associate(self, corner: PointBatch, surf: PointBatch, cw: Tensor,
                  sw: Tensor, cfg: MappingConfig) -> MapCorrespondences:
        cc = np.float32(self.cell_c)
        cs = np.float32(self.cell_s)
        fc, fs = select_fit_pair(
            self.candp_c, cw.reshape(-1, 3).contiguous(),
            _sq_f32(cc * np.float32(0.5)),
            _sq_f32(cc), dict(k=cfg.knn, mode="line", min_count=cfg.knn,
                              eig_ratio=cfg.line_eig_ratio),
            self.candp_s, sw.reshape(-1, 3).contiguous(),
            _sq_f32(cs * np.float32(0.5)),
            _sq_f32(cs), dict(k=cfg.knn,
                              mode="plane2" if cfg.plane_fallback else "plane",
                              min_count=cfg.knn, min_wide=cfg.knn,
                              tol=cfg.plane_fit_tol))
        lc, ls = corner.mask.shape, surf.mask.shape
        edge_valid = ((fc.d2[:, cfg.knn - 1].view(lc) < cfg.knn_dist_sq_max)
                      & corner.mask & fc.valid.view(lc))
        plane_valid = ((fs.d2[:, cfg.knn - 1].view(ls) < cfg.knn_dist_sq_max)
                       & surf.mask & fs.valid.view(ls))
        return MapCorrespondences(corner.xyz, fc.center.view(cw.shape),
                                  fc.normal.view(cw.shape), edge_valid,
                                  surf.xyz, fs.center.view(sw.shape),
                                  fs.normal.view(sw.shape), plane_valid)


class MappingResult(NamedTuple):
    pose: Pose
    velocity: Tensor
    n_edge: Tensor
    n_plane: Tensor
    ok: Tensor
    cost: Tensor


def _map_ok(corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
            cfg: MappingConfig) -> Tensor:
    return (corner_map.total_points() > cfg.min_map_corner) & \
           (surf_map.total_points() > cfg.min_map_surf)


def _counts(corr: MapCorrespondences):
    return corr.edge_valid.float().sum(), corr.plane_valid.float().sum()


def match_scan2map_core(corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
                        scan_corner: PointBatch, scan_surf: PointBatch,
                        pose0: Pose, cfg: MappingConfig,
                        corner_groups: Optional[vm.QueryGroups] = None,
                        surf_groups: Optional[vm.QueryGroups] = None
                        ) -> MappingResult:
    """Loosely-coupled scan-to-map Gauss-Newton. With query groups
    (``pipeline.downsample_features_grouped``) the candidates come from the
    grouped gather, without them from the one-level planar gather."""
    pose = pose0
    map_ok = _map_ok(corner_map, surf_map, cfg)
    cache = _CandidateCache.gather(corner_map, surf_map,
                                   pose.apply(scan_corner.xyz),
                                   pose.apply(scan_surf.xyz), corner_groups,
                                   surf_groups)
    zero_v = torch.zeros_like(pose0.t)
    n_edge = n_plane = cost = None
    for _ in range(cfg.outer_rounds):
        corr = cache.associate(scan_corner, scan_surf,
                               pose.apply(scan_corner.xyz),
                               pose.apply(scan_surf.xyz), cfg)
        n_edge, n_plane = _counts(corr)
        out = gn.solve_edge_plane(pose, corr[:4], corr[4:], cfg.huber_delta,
                                  cfg.gn_iterations)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = select_pose(ok_round, out.pose, pose)
        cost = out.cost
    return MappingResult(pose=pose, velocity=zero_v, n_edge=n_edge,
                         n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)


def match_scan2map(corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
                   scan_corner: PointBatch, scan_surf: PointBatch,
                   pose0: Pose, cfg: MappingConfig) -> MappingResult:
    """Loosely-coupled scan-to-map Gauss-Newton without query groups: the
    one-level planar gather, then the fused selection + fit rounds."""
    return match_scan2map_core(corner_map, surf_map, scan_corner, scan_surf,
                               pose0, cfg)


def _match_deskew(corner_map, surf_map, scan_corner: PointBatch,
                  scan_surf: PointBatch, pose0: Pose, velocity0: Tensor,
                  gravity: Tensor, corner_dk: icp.DeskewTerms,
                  surf_dk: icp.DeskewTerms, cfg: MappingConfig,
                  corner_groups, surf_groups, imu_prep, imu_weight: float
                  ) -> MappingResult:
    """The deskew-aware 9-dim matcher: with ``imu_prep`` the IMU factor
    joins the solve and the velocity is free; without it the velocity
    columns are zero and the velocity stays as given."""
    pose, vel = pose0, velocity0
    map_ok = _map_ok(corner_map, surf_map, cfg)
    cache = _CandidateCache.gather(
        corner_map, surf_map,
        icp.deskewed_world(pose, vel, scan_corner.xyz, corner_dk),
        icp.deskewed_world(pose, vel, scan_surf.xyz, surf_dk),
        corner_groups, surf_groups)
    w_imu = torch.full((1,), imu_weight, device=pose0.t.device)
    n_edge = n_plane = cost = None
    for _ in range(cfg.outer_rounds):
        cw = icp.deskewed_world(pose, vel, scan_corner.xyz, corner_dk)
        sw = icp.deskewed_world(pose, vel, scan_surf.xyz, surf_dk)
        corr = cache.associate(scan_corner, scan_surf, cw, sw, cfg)
        n_edge, n_plane = _counts(corr)

        def build(p, v, corr=corr):
            eb = icp.edge_residuals_deskew(p, v, corr.edge_points, corr.edge_c,
                                           corr.edge_n, corr.edge_valid,
                                           corner_dk)
            pb = icp.plane_residuals_deskew(p, v, corr.plane_points,
                                            corr.plane_c, corr.plane_n,
                                            corr.plane_valid, surf_dk)
            weights = [gn.huber_weights(eb, cfg.huber_delta),
                       gn.huber_weights(pb, cfg.huber_delta)]
            if imu_prep is None:
                # velocity held constant: zero its Jacobian columns
                eb = eb._replace(J=torch.cat(
                    [eb.J[..., :6], torch.zeros_like(eb.J[..., 6:9])], -1))
                pb = pb._replace(J=torch.cat(
                    [pb.J[..., :6], torch.zeros_like(pb.J[..., 6:9])], -1))
                return [eb, pb], weights
            ib = imu_factor_mod.imu_factor_blocks_from_prep(imu_prep, p, v)
            return [eb, pb, ib], weights + [w_imu]

        out = gn.gauss_newton(build, pose, vel, n_iters=cfg.gn_iterations,
                              state_dim=9)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = select_pose(ok_round, out.pose, pose)
        if imu_prep is not None:
            vel = torch.where(ok_round, out.velocity, vel)
        cost = out.cost
    return MappingResult(pose=pose, velocity=vel, n_edge=n_edge,
                         n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)


def match_scan2map_deskew_core(corner_map, surf_map, scan_corner: PointBatch,
                               scan_surf: PointBatch, pose0: Pose,
                               velocity0: Tensor, gravity: Tensor,
                               corner_dk: icp.DeskewTerms,
                               surf_dk: icp.DeskewTerms, cfg: MappingConfig,
                               corner_groups=None, surf_groups=None
                               ) -> MappingResult:
    """Scan-to-map Gauss-Newton over [pose, velocity] with per-point IMU
    deskew terms; the velocity is held constant in the solve. Query
    positions are the deskewed world points
    R (dq p + dp) + v dt - 0.5 g dt^2 + t."""
    return _match_deskew(corner_map, surf_map, scan_corner, scan_surf, pose0,
                         velocity0, gravity, corner_dk, surf_dk, cfg,
                         corner_groups, surf_groups, None, 0.0)


def match_scan2map_tight_core(corner_map, surf_map, scan_corner: PointBatch,
                              scan_surf: PointBatch, pose0: Pose,
                              velocity0: Tensor, gravity: Tensor,
                              corner_dk: icp.DeskewTerms,
                              surf_dk: icp.DeskewTerms, pre_pair, prev_state,
                              cfg: MappingConfig, imu_weight: float = 1.0,
                              corner_groups=None, surf_groups=None
                              ) -> MappingResult:
    """Tightly-coupled scan-to-map Gauss-Newton: the 15-dim IMU factor from
    the previous mapped state joins the lidar residuals in one 9-dim solve
    and the velocity is free. The state_j-independent half of the factor
    (``imu_factor_prep``) is computed once per frame."""
    imu_prep = imu_factor_mod.imu_factor_prep(
        pre_pair, prev_state, gravity, sqrt_info=sqrt_information(pre_pair))
    return _match_deskew(corner_map, surf_map, scan_corner, scan_surf, pose0,
                         velocity0, gravity, corner_dk, surf_dk, cfg,
                         corner_groups, surf_groups, imu_prep, imu_weight)
