"""Scan-to-map registration against the voxel hash maps (port of the JAX
package's ``slam/mapping.py``: ``match_scan2map_core`` on the cached,
grouped, fused-selection branch).

The 8-cell octant candidates of both feature clouds are gathered once per
frame (grouped two-level gather, rows layout); every re-association round
re-runs only the fused selection + fit kernel (``ops.select_fit``): ``line``
for corners, ``plane2`` (or ``plane``) for surfaces, then a 6-iteration
Gauss-Newton.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from msf_loam_tpu_torch.config import MappingConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch
from msf_loam_tpu_torch.core.se3 import Pose, select_pose
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.ops.select_fit import select_fit
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
    """Per-frame grouped octant gathers for both maps; each
    re-association round runs only the fused selection + fit kernel."""

    def __init__(self, corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
                 cw0: Tensor, sw0: Tensor, corner_groups: vm.QueryGroups,
                 surf_groups: vm.QueryGroups):
        self.candp_c = vm.gather_candidates_rows_grouped(
            corner_map, cw0, corner_groups.gid, corner_groups.rep_pos)
        self.candp_s = vm.gather_candidates_rows_grouped(
            surf_map, sw0, surf_groups.gid, surf_groups.rep_pos)
        self.cell_c = corner_map.cell_size
        self.cell_s = surf_map.cell_size

    def associate(self, corner: PointBatch, surf: PointBatch, cw: Tensor,
                  sw: Tensor, cfg: MappingConfig) -> MapCorrespondences:
        cc = np.float32(self.cell_c)
        cs = np.float32(self.cell_s)
        fc = select_fit(self.candp_c, cw.contiguous(),
                        _sq_f32(cc * np.float32(0.5)), _sq_f32(cc),
                        k=cfg.knn, mode="line", min_count=cfg.knn,
                        eig_ratio=cfg.line_eig_ratio)
        edge_valid = ((fc.d2[:, cfg.knn - 1] < cfg.knn_dist_sq_max)
                      & corner.mask & fc.valid)
        fs = select_fit(self.candp_s, sw.contiguous(),
                        _sq_f32(cs * np.float32(0.5)), _sq_f32(cs),
                        k=cfg.knn,
                        mode="plane2" if cfg.plane_fallback else "plane",
                        min_count=cfg.knn, min_wide=cfg.knn,
                        tol=cfg.plane_fit_tol)
        plane_valid = ((fs.d2[:, cfg.knn - 1] < cfg.knn_dist_sq_max)
                       & surf.mask & fs.valid)
        return MapCorrespondences(corner.xyz, fc.center, fc.normal,
                                  edge_valid, surf.xyz, fs.center, fs.normal,
                                  plane_valid)


class MappingResult(NamedTuple):
    pose: Pose
    n_edge: Tensor
    n_plane: Tensor
    ok: Tensor
    cost: Tensor


def match_scan2map_core(corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
                        scan_corner: PointBatch, scan_surf: PointBatch,
                        pose0: Pose, cfg: MappingConfig,
                        corner_groups: vm.QueryGroups,
                        surf_groups: vm.QueryGroups) -> MappingResult:
    """Loosely-coupled scan-to-map Gauss-Newton over query clouds grouped
    by octant base cell (``pipeline.downsample_features_grouped``)."""
    pose = pose0
    map_ok = (corner_map.total_points() > cfg.min_map_corner) & \
             (surf_map.total_points() > cfg.min_map_surf)
    cache = _CandidateCache(corner_map, surf_map, pose.apply(scan_corner.xyz),
                            pose.apply(scan_surf.xyz), corner_groups,
                            surf_groups)
    n_edge = n_plane = cost = None
    for _ in range(cfg.outer_rounds):
        corr = cache.associate(scan_corner, scan_surf,
                               pose.apply(scan_corner.xyz),
                               pose.apply(scan_surf.xyz), cfg)
        n_edge = corr.edge_valid.float().sum()
        n_plane = corr.plane_valid.float().sum()

        def build(p, corr=corr):
            eb = icp.edge_residuals(p, corr.edge_points, corr.edge_c,
                                    corr.edge_n, corr.edge_valid)
            pb = icp.plane_residuals(p, corr.plane_points, corr.plane_c,
                                     corr.plane_n, corr.plane_valid)
            return [eb, pb], [gn.huber_weights(eb, cfg.huber_delta),
                              gn.huber_weights(pb, cfg.huber_delta)]

        out = gn.gauss_newton(build, pose, n_iters=cfg.gn_iterations)
        ok_round = map_ok & ((n_edge + n_plane) >= 10)
        pose = select_pose(ok_round, out.pose, pose)
        cost = out.cost
    return MappingResult(pose=pose, n_edge=n_edge, n_plane=n_plane,
                         ok=map_ok & ((n_edge + n_plane) >= 10), cost=cost)
