"""Scan-to-map registration against the voxel hash maps: a frozen copy
of the grouped candidate path of the port's ``slam/mapping.py``. The
8-cell octant candidates of both feature clouds are gathered once per
frame by the two-level grouped gather; every re-association round runs
the selection + fit (``line`` for corners, ``plane2`` or ``plane`` for
surfaces) and ends in a 6-iteration Gauss-Newton."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.ref.config import MappingConfig
from portbench.ref.pointcloud import PointBatch
from portbench.ref.se3 import Pose, select_pose
from portbench.ref import gauss_newton as gn
from portbench.ref.select_fit import select_fit_pair
from portbench.ref import voxel_map as vm
from portbench.ref.voxel_map import _sq_f32

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


class _CandidateCache:
    """Per-frame octant candidates of both maps; each re-association round
    runs only the fused selection + fit kernel, one launch for both. The
    queries may carry a leading lane axis (the batched pipeline's B*Q
    candidate rows, lane-major): the launch then covers every lane."""

    def __init__(self, candp_c: Tensor, candp_s: Tensor, cell_c: float,
                 cell_s: float):
        self.candp_c, self.candp_s = candp_c, candp_s
        self.cell_c, self.cell_s = cell_c, cell_s

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


def _counts(corr: MapCorrespondences):
    return corr.edge_valid.sum(), corr.plane_valid.sum()


def match_scan2map(corner_map: vm.VoxelHashMap, surf_map: vm.VoxelHashMap,
                   scan_corner: PointBatch, scan_surf: PointBatch,
                   pose0: Pose, cfg: MappingConfig, corner_groups,
                   surf_groups, map_gate: bool) -> tuple:
    """Loosely-coupled scan-to-map Gauss-Newton from ``pose0``: returns
    (pose, ok). A round is kept where it found at least 10
    correspondences and, with ``map_gate`` (the single pipeline's rule;
    the batched pipeline has none), both maps hold more than their
    minimum points."""
    pose = pose0
    map_ok = torch.ones((), dtype=torch.bool, device=pose0.t.device)
    if map_gate:
        map_ok = (corner_map.total_points() > cfg.min_map_corner) & \
            (surf_map.total_points() > cfg.min_map_surf)
    cache = _CandidateCache(
        vm.gather_candidates_rows_grouped(
            corner_map, pose.apply(scan_corner.xyz), corner_groups.gid,
            corner_groups.rep_pos),
        vm.gather_candidates_rows_grouped(
            surf_map, pose.apply(scan_surf.xyz), surf_groups.gid,
            surf_groups.rep_pos),
        corner_map.cell_size, surf_map.cell_size)
    ok = map_ok
    for _ in range(cfg.outer_rounds):
        corr = cache.associate(scan_corner, scan_surf,
                               pose.apply(scan_corner.xyz),
                               pose.apply(scan_surf.xyz), cfg)
        n_edge, n_plane = _counts(corr)
        out = gn.solve_edge_plane(pose, corr[:4], corr[4:], cfg.huber_delta,
                                  cfg.gn_iterations)
        ok = map_ok & ((n_edge + n_plane) >= 10)
        pose = select_pose(ok, out.pose, pose)
    return pose, ok
