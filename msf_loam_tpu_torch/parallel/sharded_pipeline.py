"""End-to-end SLAM with the voxel maps sharded over the mesh ``map`` axis
(port of the JAX package's ``parallel/sharded_pipeline.py``).

Feature extraction, the GN solves and the pose chain run replicated on
every rank; the scan-to-scan odometry splits its query rows over the axis
(``sharded_odometry``); map storage, inserts and k-NN queries shard over
it (``sharded_map``). The frame is the dense pipeline's ``_frame_core`` /
``lio_frame_core`` with the map backend swapped through ``MapHooks``.
Every rank ends each frame with bit-identical poses.

Collectives a lidar frame (the defaults: 2 odometry rounds of 6 GN
iterations, 2 mapping rounds): 2 x (1 + 6) all-reduces for the odometry,
1 all-reduce of the map sizes, 1 all-gather per mapping round.

``MSF_SHARDED_PAIR=0`` (or ``mapping.plane_fallback=False``) takes the
two single-type queries (two all-gathers a round) instead of the packed
pair; ``MSF_SHARDED_ODO=0`` runs the dense odometry on every rank. Both
switches are the JAX package's.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from msf_loam_tpu_torch.config import MsfLoamConfig
from msf_loam_tpu_torch.core.pointcloud import RingImage, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.imu.buffer import ImuBuffer
from msf_loam_tpu_torch.ops import features as feat_mod
from msf_loam_tpu_torch.parallel import sharded_map, sharded_odometry
from msf_loam_tpu_torch.parallel.mesh import Mesh
from msf_loam_tpu_torch.slam.mapping import MapHooks
from msf_loam_tpu_torch.slam.pipeline import (FrameResult, _frame_core,
                                              lio_frame_core)


def map_hooks(mesh: Mesh, cfg: MsfLoamConfig) -> MapHooks:
    """The sharded map backend as the frame cores' hooks."""
    mc = cfg.mapping

    def query_fn(m, xyz, mask, k):
        return sharded_map.sharded_query_knn(mesh, m, xyz, mask, k=k)

    def query2_fn(m, xyz, mask, k, k2):
        return sharded_map.sharded_query_knn_2r(mesh, m, xyz, mask, k=k,
                                                k2=k2)

    def query_pair_fn(cmap, smap, cw, cmask, sw, smask):
        return sharded_map.sharded_query_pair(
            mesh, cmap, smap, cw, cmask, sw, smask, k=mc.knn,
            k2=mc.knn_wide)

    def insert_fn(m, xyz, mask):
        return sharded_map.sharded_insert(mesh, m, xyz, mask)

    def odometry_fn(prev_scan, scan, pose_c2l, oc):
        return sharded_odometry.sharded_match_scan2scan(
            mesh, prev_scan, scan, pose_c2l, oc)

    def map_ok_fn(cmap, smap, mcfg):
        n = sharded_map.map_points(mesh, cmap, smap)
        return (n[0] > mcfg.min_map_corner) & (n[1] > mcfg.min_map_surf)

    if not mc.plane_fallback or os.environ.get("MSF_SHARDED_PAIR", "1") == "0":
        query_pair_fn = None
    if os.environ.get("MSF_SHARDED_ODO", "1") == "0":
        odometry_fn = None
    return MapHooks(query_fn=query_fn, query2_fn=query2_fn,
                    query_pair_fn=query_pair_fn, insert_fn=insert_fn,
                    odometry_fn=odometry_fn, map_ok_fn=map_ok_fn)


def sharded_lio_frame(mesh: Mesh, cfg: MsfLoamConfig, *args, **kwargs):
    """One tightly-coupled LIO frame against the sharded maps; the
    arguments are ``slam.pipeline.lio_frame_core``'s after ``cfg``, the
    maps being this rank's shards."""
    return lio_frame_core(cfg, *args, hooks=map_hooks(mesh, cfg), **kwargs)


class ShardedSlamPipeline:
    """``SlamPipeline``'s lidar-only frames with the maps sharded over
    ``mesh``'s ``map`` axis; every tensor lives on ``mesh.device``."""

    def __init__(self, config: MsfLoamConfig, mesh: Mesh):
        self.cfg = config
        self.mesh = mesh
        self.device = mesh.device
        self.hooks = map_hooks(mesh, config)
        mc = config.mapping
        self.corner_map = sharded_map.create_sharded_map(
            mesh, mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
            mc.line_resolution)
        self.surf_map = sharded_map.create_sharded_map(
            mesh, mc.map_table_size, mc.map_cell_capacity, mc.map_cell_size,
            mc.plane_resolution)
        dev = self.device
        self.pose_odom = Pose.identity(dev)
        self.pose_curr2last = Pose.identity(dev)
        self.pose_odom2map = Pose.identity(dev)
        self.pose_map = Pose.identity(dev)
        self.prev_scan: Optional[ScanFeatures] = None
        self.results: List[FrameResult] = []
        self.frame_idx = 0
        # run_slam's surface; the sharded pipeline takes no IMU
        self.is_initialized = False
        self.gravity = torch.tensor(config.imu.gravity, dtype=torch.float32,
                                    device=dev)
        self.imu_buffer = ImuBuffer(capacity=1)

    def add_imu(self, t: float, acc, gyr) -> None:
        raise RuntimeError("ShardedSlamPipeline is lidar-only; drive the "
                           "sharded LIO frame with sharded_lio_frame")

    def process_ring_image(self, ring_image: RingImage,
                           scan_time: float) -> FrameResult:
        """One frame from a raw RingImage (extraction replicated)."""
        t = torch.full((), scan_time, dtype=torch.float32, device=self.device)
        return self.process_scan(feat_mod.extract_features(
            ring_image, t, self.cfg.features))

    def process_scan(self, scan: ScanFeatures) -> FrameResult:
        cfg = self.cfg
        is_first = self.prev_scan is None
        prev = scan if is_first else self.prev_scan
        (self.corner_map, self.surf_map, self.pose_curr2last,
         self.pose_odom, self.pose_odom2map, self.pose_map, n_corr,
         ok) = _frame_core(
            cfg, self.corner_map, self.surf_map, prev, scan,
            self.pose_curr2last, self.pose_odom, self.pose_odom2map,
            torch.full((), is_first, device=self.device), hooks=self.hooks)
        # periodic far-point eviction at SlamPipeline's cadence
        mc = cfg.mapping
        self.frame_idx += 1
        if mc.map_evict_period > 0 and \
                self.frame_idx % mc.map_evict_period == 0:
            center = self.pose_map.t
            self.corner_map = sharded_map.sharded_evict_far(
                self.mesh, self.corner_map, center, mc.map_evict_radius)
            self.surf_map = sharded_map.sharded_evict_far(
                self.mesh, self.surf_map, center, mc.map_evict_radius)
        self.prev_scan = scan
        res = FrameResult(time=float(scan.time), odom_pose=self.pose_odom,
                          map_pose=self.pose_map,
                          n_correspondences=float(n_corr), ok=bool(ok))
        self.results.append(res)
        return res

    def map_points(self) -> np.ndarray:
        """Stored points of the whole corner and surface maps (one
        all-reduce; every rank calls it)."""
        return sharded_map.map_points(
            self.mesh, self.corner_map, self.surf_map).cpu().numpy()

    def trajectory(self) -> np.ndarray:
        """(N, 8) array [time, t(3), q(wxyz)] of mapping-frame poses."""
        rows = [np.concatenate([[r.time], r.map_pose.t.cpu().numpy(),
                                r.map_pose.q.cpu().numpy()])
                for r in self.results]
        return np.asarray(rows)
