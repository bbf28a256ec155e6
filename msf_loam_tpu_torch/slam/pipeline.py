"""The SLAM frames on torch tensors (port of the JAX package's
``slam/pipeline.py``): the lidar-only frame (``fused_frame_step_from_image``
/ ``_frame_core``), the tightly-coupled LIO frame (``lio_frame_core``) and
the host-side ``SlamPipeline`` with its IMU estimator.

Lidar-only frame: feature extraction (pick_rounds kernel) -> scan-to-scan
odometry (odo_corr + select_fit kernels) -> grouped voxel downsample of
the query clouds -> octant candidate gather -> scan-to-map Gauss-Newton
(select_fit kernel) -> insert into the two voxel hash maps.

LIO frame (after the estimator is initialised): the same extraction and
odometry, then the pair and scan windows' preintegration, the IMU-only
pre-solve, the downsample grouped at the IMU-predicted deskewed world
positions, the deskew-aware (or tightly-coupled) scan-to-map Gauss-Newton,
the full deskew and the insert. Both fused frames keep their watchdogs on
the device; nothing synchronises with the host inside them. Before the
estimator is initialised, IMU frames take the modular ``process_scan``
route, which synchronises with the host where the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from msf_loam_tpu_torch.config import MsfLoamConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, RingImage, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose, select_pose
from msf_loam_tpu_torch.imu import bias_estimator, gravity_init
from msf_loam_tpu_torch.imu import deskew as deskew_mod
from msf_loam_tpu_torch.imu import imu_factor as imu_factor_mod
from msf_loam_tpu_torch.imu import preintegration as preint_mod
from msf_loam_tpu_torch.imu.buffer import ImuBuffer
from msf_loam_tpu_torch.ops import features as feat_mod
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.ops.voxel import (voxel_downsample_compact_idx,
                                          voxel_downsample_grouped_idx)
from msf_loam_tpu_torch.slam import mapping, odometry
from msf_loam_tpu_torch.slam import voxel_map as vm

Tensor = torch.Tensor


def downsample_features(pb: PointBatch, leaf: float,
                        capacity: int) -> PointBatch:
    """Voxel-thin a feature cloud and compact it to a fixed query budget
    (never above the input capacity); rows come out in voxel-key order.
    The leaf divides as a tensor, as the reference's separately compiled
    downsample divides by its traced leaf."""
    capacity = min(capacity, pb.xyz.shape[-2])
    leaf_t = torch.full((), leaf, dtype=torch.float32, device=pb.xyz.device)
    idx, valid = voxel_downsample_compact_idx(pb.xyz, pb.mask, leaf_t,
                                              capacity)
    return pb.take(idx, valid)


def downsample_features_grouped(pb: PointBatch, leaf: float, capacity: int,
                                key_world: Tensor, cell_size: float,
                                group_budget: int):
    """Voxel-thin a feature cloud, compact it to a fixed query budget (never
    above the input capacity) and group it by the map octant base cell of
    ``key_world`` (each input point's world position at the matcher's
    query transform). Returns (PointBatch, QueryGroups). A leading lane
    axis on the cloud and the keys downsamples B lanes at once, each
    sorted alone."""
    capacity = min(capacity, pb.xyz.shape[-2])
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


def _odometry_step(cfg: MsfLoamConfig, prev_scan: ScanFeatures,
                   scan: ScanFeatures, pose_c2l: Pose, pose_odom: Pose,
                   is_first: Tensor):
    """Scan-to-scan odometry with its watchdog: (odometry result, new
    pose_c2l, new pose_odom)."""
    odo = odometry.match_scan2scan(prev_scan, scan, pose_c2l, cfg.odometry)
    use = odo.ok & ~is_first & pose_is_finite(odo.pose_curr2last)
    pose_c2l = select_pose(use, odo.pose_curr2last, pose_c2l)
    step_pose = select_pose(is_first, Pose.identity(pose_c2l.t.device),
                            pose_c2l)
    return odo, pose_c2l, pose_odom.compose(step_pose)


def _insert_both(corner_map, surf_map, corner: PointBatch, surf: PointBatch,
                 pose_map: Pose):
    cw = corner.transform(pose_map)
    sw = surf.transform(pose_map)
    return (vm.insert(corner_map, cw.xyz, finite_point_mask(cw.mask, cw.xyz)),
            vm.insert(surf_map, sw.xyz, finite_point_mask(sw.mask, sw.xyz)))


def _frame_core(cfg: MsfLoamConfig, corner_map, surf_map,
                prev_scan: ScanFeatures, scan: ScanFeatures, pose_c2l: Pose,
                pose_odom: Pose, pose_o2m: Pose, is_first: Tensor):
    """Lidar-only frame body (no motion deskew)."""
    mc = cfg.mapping
    odo, pose_c2l, pose_odom = _odometry_step(cfg, prev_scan, scan,
                                              pose_c2l, pose_odom, is_first)
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
    corner_map, surf_map = _insert_both(corner_map, surf_map, corner_ds,
                                        surf_ds, pose_map)
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


def _all_finite(x: Tensor) -> Tensor:
    return torch.isfinite(x).all()


def lio_frame_core(cfg: MsfLoamConfig, corner_map, surf_map,
                   prev_scan: ScanFeatures, ring_image: RingImage,
                   scan_time: Tensor, pose_c2l: Pose, pose_odom: Pose,
                   pose_o2m: Pose, is_first: Tensor,
                   pair_dts, pair_accs, pair_gyrs, pair_valid,
                   scan_dts, scan_accs, scan_gyrs, scan_valid,
                   prev_p, prev_q, prev_v, gravity, ba=None, bg=None):
    """The tightly-coupled (post-initialisation) frame: extraction,
    scan-to-scan odometry, pair and scan preintegration, the IMU pre-solve,
    the downsample grouped at the IMU-predicted deskewed world positions,
    the deskew-aware (``tight_coupling``: IMU factor in the solve, velocity
    free) scan-to-map Gauss-Newton, the full deskew and the insert.
    Returns (corner_map, surf_map, pose_c2l, pose_odom, pose_o2m, pose_map,
    velocity, n_correspondences, ok, scan)."""
    mc, ic = cfg.mapping, cfg.imu
    scan = feat_mod.extract_features(ring_image, scan_time, cfg.features)
    odo, pose_c2l, pose_odom = _odometry_step(cfg, prev_scan, scan,
                                              pose_c2l, pose_odom, is_first)

    # the IMU prediction of this frame's state from the previous mapped
    # state, with the preintegration linearised at the online biases
    ba = torch.zeros_like(gravity) if ba is None else ba
    bg = torch.zeros_like(gravity) if bg is None else bg
    pre_pair = preint_mod.preintegrate(pair_dts, pair_accs, pair_gyrs,
                                       pair_valid, ba, bg, ic)
    prev_state = imu_factor_mod.ImuState(pose=Pose(prev_p, prev_q), v=prev_v,
                                         ba=ba, bg=bg)
    pred = imu_factor_mod.imu_presolve(pre_pair, prev_state, gravity,
                                       info_scale=ic.sqrt_info_scale)
    pre_scan = preint_mod.preintegrate(scan_dts, scan_accs, scan_gyrs,
                                       scan_valid, ba, bg, ic)

    # grouping keys: deskewed world positions at the IMU-predicted state,
    # the transform the matcher's candidate cache applies to the queries
    def _key_world(pb: PointBatch) -> Tensor:
        dk = deskew_mod.deskew_terms(pre_scan, pb.rel_time, gravity)
        return icp.deskewed_world(pred.pose, pred.v, pb.xyz, dk)

    corner_ds, corner_groups = downsample_features_grouped(
        scan.corner_less_sharp, mc.line_resolution, mc.corner_query_points,
        _key_world(scan.corner_less_sharp), mc.map_cell_size,
        mc.gather_groups)
    surf_ds, surf_groups = downsample_features_grouped(
        scan.surf_less_flat, mc.plane_resolution, mc.max_query_points,
        _key_world(scan.surf_less_flat), mc.map_cell_size, mc.gather_groups)

    corner_dk = deskew_mod.deskew_terms(pre_scan, corner_ds.rel_time, gravity)
    surf_dk = deskew_mod.deskew_terms(pre_scan, surf_ds.rel_time, gravity)
    if ic.tight_coupling:
        mres = mapping.match_scan2map_tight_core(
            corner_map, surf_map, corner_ds, surf_ds, pred.pose, pred.v,
            gravity, corner_dk, surf_dk, pre_pair, prev_state, mc,
            imu_weight=ic.imu_factor_weight, corner_groups=corner_groups,
            surf_groups=surf_groups)
    else:
        mres = mapping.match_scan2map_deskew_core(
            corner_map, surf_map, corner_ds, surf_ds, pred.pose, pred.v,
            gravity, corner_dk, surf_dk, mc, corner_groups=corner_groups,
            surf_groups=surf_groups)
    guess = pose_o2m.compose(pose_odom)
    # watchdog: a non-finite solve (NaN IMU sample, degenerate geometry)
    # never leaks into the pose chain
    solve_ok = mres.ok & pose_is_finite(mres.pose)
    pose_map = select_pose(solve_ok, mres.pose, guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())
    # velocity fallback chain: solved -> IMU-predicted -> previous frame's
    if ic.tight_coupling:
        vel = torch.where(solve_ok & _all_finite(mres.velocity),
                          mres.velocity, pred.v)
    else:
        vel = pred.v
    vel = torch.where(_all_finite(vel), vel, prev_v)

    corner_fix = deskew_mod.undistort_full(corner_ds, pre_scan, pose_map, vel,
                                           gravity)
    surf_fix = deskew_mod.undistort_full(surf_ds, pre_scan, pose_map, vel,
                                         gravity)
    corner_map, surf_map = _insert_both(corner_map, surf_map, corner_fix,
                                        surf_fix, pose_map)
    return (corner_map, surf_map, pose_c2l, pose_odom, pose_o2m, pose_map,
            vel, odo.n_correspondences, odo.ok | is_first, scan)


class SlamPipeline:
    """Stateful frame-by-frame SLAM pipeline (single trajectory), lidar-only
    or, once ``add_imu`` has fed more than ``imu.warmup_msgs`` samples,
    LiDAR-inertial.

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
        # IMU estimator state; every tensor lives on the pipeline's device
        self.imu_buffer = ImuBuffer()
        self.velocity = torch.zeros(3, device=device)
        self.gravity = torch.tensor(config.imu.gravity, dtype=torch.float32,
                                    device=device)
        self.bias_acc = torch.zeros(3, device=device)
        self.bias_gyr = torch.zeros(3, device=device)
        self.is_initialized = False
        # mapped states: time, p, q, v, and for every state but the last the
        # preintegration ``pre`` to the next one (delta_p, delta_v its parts)
        self._states: List[dict] = []

    def _f32(self, x) -> Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _scalar(self, x, dtype) -> Tensor:
        return torch.full((), x, dtype=dtype, device=self.device)

    # ------------------------------------------------------------ IMU
    def add_imu(self, t: float, acc, gyr) -> None:
        """Feed one IMU sample (time in seconds, specific force, rate)."""
        self.imu_buffer.add(t, acc, gyr)

    @property
    def has_imu(self) -> bool:
        """The IMU is used once more than ``warmup_msgs`` samples arrived."""
        return len(self.imu_buffer) > self.cfg.imu.warmup_msgs

    def _window(self, start: float, end: float):
        ic = self.cfg.imu
        w = self.imu_buffer.window(start, end, ic.max_imu_samples,
                                   ic.max_lidar_imu_offset)
        return (self._f32(w.dts), self._f32(w.accs), self._f32(w.gyrs),
                torch.as_tensor(w.valid, device=self.device))

    def _preintegrate_window(self, start: float, end: float):
        return preint_mod.preintegrate(*self._window(start, end),
                                       self.bias_acc, self.bias_gyr,
                                       self.cfg.imu)

    def _estimator_add(self, time: float, pose: Pose, velocity: Tensor) -> None:
        """Collect the mapped state; at ``init_frames`` states run the
        gravity/velocity solve, then refine gravity and solve the biases
        periodically."""
        ic = self.cfg.imu
        st = dict(time=time, p=pose.t, q=pose.q, v=velocity, delta_p=None,
                  delta_v=None)
        if self._states:
            prev = self._states[-1]
            pre = self._preintegrate_window(prev["time"], time)
            prev["delta_p"] = pre.delta_p
            prev["delta_v"] = pre.delta_v
            prev["pre"] = pre
        self._states.append(st)
        n = len(self._states)
        if n == ic.init_frames and not self.is_initialized:
            out = self._solve_gravity_window(self._states)
            if self._grav_out_finite(out):
                self.gravity = out.gravity
                self.velocity = out.velocities[-1]
                for i, s in enumerate(self._states):
                    s["v"] = out.velocities[i]
            self.is_initialized = True
        elif (self.is_initialized and ic.grav_refine_period > 0
              and n >= 2 * ic.init_frames
              and n % ic.grav_refine_period == 0):
            out = self._solve_gravity_window(self._states[-ic.init_frames:])
            if self._grav_out_finite(out):
                self.gravity = out.gravity
                self.velocity = out.velocities[-1]
                self._states[-1]["v"] = out.velocities[-1]
        if (self.is_initialized and ic.bias_period > 0
                and n >= ic.bias_window + 1 and n % ic.bias_period == 0):
            self._solve_bias()

    @staticmethod
    def _grav_out_finite(out) -> bool:
        """Never commit a non-finite gravity/velocity solution."""
        return bool(_all_finite(out.gravity) & _all_finite(out.velocities))

    def _solve_bias(self) -> None:
        """Windowed shared-bias Gauss-Newton over the last bias_window pairs
        of mapped states (``imu.bias_estimator``), blended into the
        estimate by an exponential moving average."""
        ic = self.cfg.imu
        sts = self._states[-(ic.bias_window + 1):]
        if any(s.get("pre") is None for s in sts[:-1]):
            return
        pres = preint_mod.Preintegration(*(
            torch.stack(fields) for fields in zip(*(s["pre"]
                                                    for s in sts[:-1]))))
        pair_valid = (pres.sum_dt > 1e-6) \
            & torch.isfinite(pres.delta_p).all(-1) \
            & torch.isfinite(pres.delta_v).all(-1)
        out = bias_estimator.solve_bias_window(
            torch.stack([s["p"] for s in sts]),
            torch.stack([s["q"] for s in sts]),
            torch.stack([s["v"] for s in sts]), pres, pair_valid,
            self.gravity, self.bias_acc, self.bias_gyr, ic)
        if not bool(_all_finite(out.ba) & _all_finite(out.bg)
                    & _all_finite(out.velocities[-1])):
            return
        a = ic.bias_ema
        self.bias_acc = a * self.bias_acc + (1 - a) * out.ba
        self.bias_gyr = a * self.bias_gyr + (1 - a) * out.bg
        self.velocity = out.velocities[-1]
        self._states[-1]["v"] = out.velocities[-1]

    def _solve_gravity_window(self, states) -> gravity_init.GravityInitResult:
        """Gravity/velocity least squares over consecutive mapped states."""
        N = len(states)
        dt = self._f32(np.asarray([states[i + 1]["time"] - states[i]["time"]
                                   for i in range(N - 1)], np.float32))
        dps = torch.stack([states[i]["delta_p"] for i in range(N - 1)])
        dvs = torch.stack([states[i]["delta_v"] for i in range(N - 1)])
        ok = torch.isfinite(dps).all(dim=1) & (dt > 1e-6)
        return gravity_init.solve_gravity_velocity(
            torch.stack([s["p"] for s in states]),
            torch.stack([s["q"] for s in states]), dt, dps, dvs, ok,
            self.gravity, n_frames=N,
            reject_frac=self.cfg.imu.init_reject_frac)

    # ------------------------------------------------------------ frames
    def process_scan(self, scan: ScanFeatures) -> FrameResult:
        """One frame from extracted features: the lidar-only fused frame
        without an IMU, else the modular IMU path (rotation-only deskew
        before initialisation, the IMU-coupled matcher after it)."""
        cfg = self.cfg
        scan_time = float(scan.time)
        if not self.has_imu:
            return self._process_scan_fused(scan)

        if not self.is_initialized:
            pre_scan = self._preintegrate_window(
                scan_time, scan_time + cfg.features.scan_period)
            if int(pre_scan.n_samples) > 0:
                scan = deskew_mod.undistort_scan_rotation_only(scan, pre_scan)

        if self.prev_scan is None:
            odom_ok, n_corr = True, 0.0
        else:
            out = odometry.match_scan2scan(self.prev_scan, scan,
                                           self.pose_curr2last, cfg.odometry)
            odom_ok = bool(out.ok)
            n_corr = float(out.n_correspondences)
            if odom_ok:
                self.pose_curr2last = out.pose_curr2last
            self.pose_odom = self.pose_odom.compose(self.pose_curr2last)

        mc = cfg.mapping
        corner_ds = downsample_features(scan.corner_less_sharp,
                                        mc.line_resolution,
                                        mc.corner_query_points)
        surf_ds = downsample_features(scan.surf_less_flat,
                                      mc.plane_resolution, mc.max_query_points)

        pose_guess = self.pose_odom2map.compose(self.pose_odom)
        pre_scan = None
        if self.is_initialized and self._states:
            # IMU-only pre-solve from the previous mapped state, then the
            # deskew-aware lidar Gauss-Newton
            prev = self._states[-1]
            pre_pair = self._preintegrate_window(prev["time"], scan_time)
            prev_state = imu_factor_mod.ImuState(
                pose=Pose(prev["p"], prev["q"]), v=prev["v"],
                ba=self.bias_acc, bg=self.bias_gyr)
            pred = imu_factor_mod.imu_presolve(
                pre_pair, prev_state, self.gravity,
                info_scale=cfg.imu.sqrt_info_scale)
            if bool(_all_finite(pred.v)):
                self.velocity = pred.v
            pre_scan = self._preintegrate_window(
                scan_time, scan_time + cfg.features.scan_period)
            corner_dk = deskew_mod.deskew_terms(pre_scan, corner_ds.rel_time,
                                                self.gravity)
            surf_dk = deskew_mod.deskew_terms(pre_scan, surf_ds.rel_time,
                                              self.gravity)
            if cfg.imu.tight_coupling:
                mres = mapping.match_scan2map_tight_core(
                    self.corner_map, self.surf_map, corner_ds, surf_ds,
                    pred.pose, self.velocity, self.gravity, corner_dk,
                    surf_dk, pre_pair, prev_state, mc,
                    imu_weight=cfg.imu.imu_factor_weight)
                if bool(mres.ok) and bool(_all_finite(mres.velocity)):
                    self.velocity = mres.velocity
            else:
                mres = mapping.match_scan2map_deskew_core(
                    self.corner_map, self.surf_map, corner_ds, surf_ds,
                    pred.pose, self.velocity, self.gravity, corner_dk,
                    surf_dk, mc)
        else:
            mres = mapping.match_scan2map_core(self.corner_map, self.surf_map,
                                               corner_ds, surf_ds, pose_guess,
                                               mc)
        # watchdog: a degenerate solve falls back to the guess
        self.pose_map = mres.pose if (bool(mres.ok)
                                      and bool(pose_is_finite(mres.pose))) \
            else pose_guess
        self.pose_odom2map = self.pose_map.compose(self.pose_odom.inverse())

        if self.is_initialized and pre_scan is not None:
            corner_ds = deskew_mod.undistort_full(corner_ds, pre_scan,
                                                  self.pose_map,
                                                  self.velocity, self.gravity)
            surf_ds = deskew_mod.undistort_full(surf_ds, pre_scan,
                                                self.pose_map, self.velocity,
                                                self.gravity)
        self.corner_map, self.surf_map = _insert_both(
            self.corner_map, self.surf_map, corner_ds, surf_ds, self.pose_map)
        self._estimator_add(scan_time, self.pose_map, self.velocity)
        return self._finish(scan, scan_time, n_corr, odom_ok)

    def _finish(self, scan: ScanFeatures, scan_time: float, n_corr,
                ok) -> FrameResult:
        self.prev_scan = scan
        self.frame_idx += 1
        self._maybe_evict()
        res = FrameResult(time=scan_time, odom_pose=self.pose_odom,
                          map_pose=self.pose_map,
                          n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    def process_ring_image(self, ring_image: RingImage,
                           scan_time: float) -> FrameResult:
        """One frame from a raw RingImage (on this pipeline's device):
        the fused LIO frame once the estimator is initialised, the modular
        ``process_scan`` for IMU frames before that, else the fused
        lidar-only frame."""
        t = self._scalar(scan_time, torch.float32)
        if self.has_imu and self.is_initialized and self._states \
                and self.prev_scan is not None:
            return self._process_lio_fused(ring_image, scan_time)
        if self.has_imu:
            return self.process_scan(feat_mod.extract_features(
                ring_image, t, self.cfg.features))
        is_first = self.prev_scan is None
        prev = (feat_mod.extract_features(ring_image, t, self.cfg.features)
                if is_first else self.prev_scan)
        (self.corner_map, self.surf_map, self.pose_curr2last, self.pose_odom,
         self.pose_odom2map, self.pose_map, n_corr, ok,
         scan) = fused_frame_step_from_image(
            self.cfg, self.corner_map, self.surf_map, prev, ring_image, t,
            self.pose_curr2last, self.pose_odom, self.pose_odom2map,
            self._scalar(is_first, torch.bool))
        return self._finish(scan, scan_time, n_corr, ok)

    def _process_scan_fused(self, scan: ScanFeatures) -> FrameResult:
        is_first = self.prev_scan is None
        prev = scan if is_first else self.prev_scan
        (self.corner_map, self.surf_map, self.pose_curr2last, self.pose_odom,
         self.pose_odom2map, self.pose_map, n_corr, ok) = _frame_core(
            self.cfg, self.corner_map, self.surf_map, prev, scan,
            self.pose_curr2last, self.pose_odom, self.pose_odom2map,
            self._scalar(is_first, torch.bool))
        return self._finish(scan, float(scan.time), n_corr, ok)

    def _process_lio_fused(self, ring_image: RingImage,
                           scan_time: float) -> FrameResult:
        cfg = self.cfg
        prev = self._states[-1]
        wp = self._window(prev["time"], scan_time)
        ws = self._window(scan_time, scan_time + cfg.features.scan_period)
        (self.corner_map, self.surf_map, self.pose_curr2last, self.pose_odom,
         self.pose_odom2map, self.pose_map, self.velocity, n_corr, ok,
         scan) = lio_frame_core(
            cfg, self.corner_map, self.surf_map, self.prev_scan, ring_image,
            self._scalar(scan_time, torch.float32), self.pose_curr2last,
            self.pose_odom, self.pose_odom2map,
            self._scalar(False, torch.bool), *wp, *ws, prev["p"], prev["q"],
            prev["v"], self.gravity, ba=self.bias_acc, bg=self.bias_gyr)
        self._estimator_add(scan_time, self.pose_map, self.velocity)
        return self._finish(scan, scan_time, n_corr, ok)

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
