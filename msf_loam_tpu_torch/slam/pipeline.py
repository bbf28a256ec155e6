"""The lidar-only SLAM frame on torch tensors (port of the JAX package's
``slam/pipeline.py``: ``fused_frame_step_from_image`` / ``_frame_core``
and the host driver ``SlamPipeline``).

Per frame: feature extraction (pick_rounds kernel) -> scan-to-scan
odometry (odo_corr + select_fit kernels) -> grouped voxel downsample of
the query clouds -> octant candidate gather -> scan-to-map Gauss-Newton
(select_fit kernel) -> insert into the two voxel hash maps. Every step
runs on the device of the maps; nothing synchronises with the host inside
a frame (watchdogs are device-side selects).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from msf_loam_tpu_torch.config import MsfLoamConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, RingImage, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose, select_pose
from msf_loam_tpu_torch.ops import features as feat_mod
from msf_loam_tpu_torch.ops.voxel import voxel_downsample_grouped_idx
from msf_loam_tpu_torch.slam import mapping, odometry
from msf_loam_tpu_torch.slam import voxel_map as vm

Tensor = torch.Tensor


def downsample_features_grouped(pb: PointBatch, leaf: float, capacity: int,
                                key_world: Tensor, cell_size: float,
                                group_budget: int):
    """Voxel-thin a feature cloud, compact it to a fixed query budget (never
    above the input capacity) and group it by the map octant base cell of
    ``key_world`` (each input point's world position at the matcher's
    query transform). Returns (PointBatch, QueryGroups)."""
    capacity = min(capacity, pb.xyz.shape[0])
    idx, valid, gid, rep_pos = voxel_downsample_grouped_idx(
        pb.xyz, pb.mask, leaf, capacity, key_world, cell_size, group_budget)
    return pb.take(idx, valid), vm.QueryGroups(gid=gid, rep_pos=rep_pos)


def pose_is_finite(pose: Pose) -> Tensor:
    """0-d bool tensor: every pose component is finite."""
    return torch.isfinite(pose.t).all() & torch.isfinite(pose.q).all()


def finite_point_mask(mask: Tensor, xyz: Tensor) -> Tensor:
    """Never let a non-finite point into the map."""
    return mask & torch.isfinite(xyz).all(dim=-1)


@dataclasses.dataclass
class FrameResult:
    time: float
    odom_pose: Pose
    map_pose: Pose
    n_correspondences: float
    ok: bool


def _frame_core(cfg: MsfLoamConfig, corner_map, surf_map,
                prev_scan: ScanFeatures, scan: ScanFeatures, pose_c2l: Pose,
                pose_odom: Pose, pose_o2m: Pose, is_first: Tensor):
    """Lidar-only frame body (no motion deskew)."""
    oc, mc = cfg.odometry, cfg.mapping
    odo = odometry.match_scan2scan(prev_scan, scan, pose_c2l, oc)
    use = odo.ok & ~is_first & pose_is_finite(odo.pose_curr2last)
    pose_c2l = select_pose(use, odo.pose_curr2last, pose_c2l)
    step_pose = select_pose(is_first, Pose.identity(pose_c2l.t.device),
                            pose_c2l)
    pose_odom = pose_odom.compose(step_pose)

    guess = pose_o2m.compose(pose_odom)
    corner_ds, corner_groups = downsample_features_grouped(
        scan.corner_less_sharp, mc.line_resolution, mc.corner_query_points,
        guess.apply(scan.corner_less_sharp.xyz), mc.map_cell_size,
        mc.gather_groups)
    surf_ds, surf_groups = downsample_features_grouped(
        scan.surf_less_flat, mc.plane_resolution, mc.max_query_points,
        guess.apply(scan.surf_less_flat.xyz), mc.map_cell_size,
        mc.gather_groups)

    mres = mapping.match_scan2map_core(corner_map, surf_map, corner_ds,
                                       surf_ds, guess, mc, corner_groups,
                                       surf_groups)
    # watchdog: a non-finite solve falls back to the odometry guess
    pose_map = select_pose(mres.ok & pose_is_finite(mres.pose), mres.pose,
                           guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())

    cw = corner_ds.transform(pose_map)
    sw = surf_ds.transform(pose_map)
    corner_map = vm.insert(corner_map, cw.xyz,
                           finite_point_mask(cw.mask, cw.xyz))
    surf_map = vm.insert(surf_map, sw.xyz, finite_point_mask(sw.mask, sw.xyz))
    return (corner_map, surf_map, pose_c2l, pose_odom, pose_o2m, pose_map,
            odo.n_correspondences, odo.ok | is_first)


def fused_frame_step_from_image(cfg: MsfLoamConfig, corner_map, surf_map,
                                prev_scan: ScanFeatures, ring_image: RingImage,
                                scan_time: Tensor, pose_c2l: Pose,
                                pose_odom: Pose, pose_o2m: Pose,
                                is_first: Tensor):
    """The whole lidar-only frame from the raw RingImage: feature
    extraction followed by ``_frame_core``; returns its outputs plus the
    frame's ScanFeatures."""
    scan = feat_mod.extract_features(ring_image, scan_time, cfg.features)
    out = _frame_core(cfg, corner_map, surf_map, prev_scan, scan, pose_c2l,
                      pose_odom, pose_o2m, is_first)
    return out + (scan,)


class SlamPipeline:
    """Stateful frame-by-frame lidar-only SLAM driver (single trajectory).

    Runs on ``device`` (the card by default); a machine without CUDA
    raises instead of falling back to the CPU. Pass ``device="cpu"`` to
    run the kernels' plain PyTorch versions."""

    def __init__(self, config: MsfLoamConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SlamPipeline(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run the plain "
                               "PyTorch versions of the kernels")
        self.cfg = config
        self.device = device
        mc = config.mapping
        self.corner_map = vm.create_map(mc.map_table_size,
                                        mc.map_cell_capacity,
                                        mc.map_cell_size, mc.line_resolution,
                                        device=device)
        self.surf_map = vm.create_map(mc.map_table_size, mc.map_cell_capacity,
                                      mc.map_cell_size, mc.plane_resolution,
                                      device=device)
        self.pose_odom = Pose.identity(device)
        self.pose_curr2last = Pose.identity(device)
        self.pose_odom2map = Pose.identity(device)
        self.pose_map = Pose.identity(device)
        self.prev_scan: Optional[ScanFeatures] = None
        self.results: List[FrameResult] = []
        self.frame_idx = 0

    def process_ring_image(self, ring_image: RingImage,
                           scan_time: float) -> FrameResult:
        """One frame from a raw RingImage (on this pipeline's device)."""
        is_first = self.prev_scan is None
        t = torch.full((), scan_time, dtype=torch.float32, device=self.device)
        prev = (feat_mod.extract_features(ring_image, t, self.cfg.features)
                if is_first else self.prev_scan)
        (self.corner_map, self.surf_map, self.pose_curr2last, self.pose_odom,
         self.pose_odom2map, self.pose_map, n_corr, ok,
         scan) = fused_frame_step_from_image(
            self.cfg, self.corner_map, self.surf_map, prev, ring_image, t,
            self.pose_curr2last, self.pose_odom, self.pose_odom2map,
            torch.full((), is_first, dtype=torch.bool, device=self.device))
        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(time=scan_time, odom_pose=self.pose_odom,
                          map_pose=self.pose_map,
                          n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    def _maybe_evict(self) -> None:
        """Periodically release map points far from the current pose."""
        mc = self.cfg.mapping
        if mc.map_evict_period > 0 and \
                self.frame_idx % mc.map_evict_period == 0:
            self.corner_map = vm.evict_far(self.corner_map, self.pose_map.t,
                                           mc.map_evict_radius)
            self.surf_map = vm.evict_far(self.surf_map, self.pose_map.t,
                                         mc.map_evict_radius)

    def trajectory(self) -> np.ndarray:
        """(N, 8) array [time, t(3), q(wxyz)] of mapping-frame poses."""
        rows = [np.concatenate([[r.time], r.map_pose.t.cpu().numpy(),
                                r.map_pose.q.cpu().numpy()])
                for r in self.results]
        return np.asarray(rows)


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) Umeyama
    alignment."""
    assert est_t.shape == gt_t.shape
    if align:
        mu_e, mu_g = est_t.mean(0), gt_t.mean(0)
        E, G = est_t - mu_e, gt_t - mu_g
        W = G.T @ E
        U, _, Vt = np.linalg.svd(W)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        t = mu_g - R @ mu_e
        est_t = est_t @ R.T + t
    err = est_t - gt_t
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
