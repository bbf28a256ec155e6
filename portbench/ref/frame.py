"""The plain reference of the port's lidar frame, replayed over a session.

Frozen copies of the port's plain PyTorch frame (``slam/pipeline.py``'s
``_frame_core`` and ``query_clouds``, ``slam/batch_pipeline.py``'s
``_frame_fn``) over the copied stages beside it: feature extraction,
scan-to-scan odometry, the motion-deskewed grouped downsample, the
grouped octant gather and scan-to-map Gauss-Newton, the insert into the
two voxel hash maps and the eviction. Nothing here imports the program;
the kernels' work is done by their plain definitions. It runs in the
default dtype (float32 for the check, the configuration's precision) on
any device.

``Replay`` holds one session's maps and pose state. ``frame`` works out a
frame's odometry step and mapped pose from that state; ``advance`` then
moves the state on with the poses given: the program's (the check, which
so compares one frame at a time) or its own (a run of the reference in
the program's place).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from portbench.ref import mapping
from portbench.ref import odometry
from portbench.ref import voxel_map as vm
from portbench.ref.config import FrameConfig
from portbench.ref.deskew import undistort_from_motion
from portbench.ref.features import extract_features
from portbench.ref.pointcloud import PointBatch, RingImage, ScanFeatures
from portbench.ref.se3 import Pose, select_pose
from portbench.ref.voxel import voxel_downsample_grouped_idx

Tensor = torch.Tensor


@contextlib.contextmanager
def precision(dtype: torch.dtype, tf32: bool = False):
    """Run the block with ``dtype`` as torch's default floating type and
    float32 matrix products in TF32 or not; both are restored after."""
    old = torch.get_default_dtype()
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_default_dtype(dtype)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.set_default_dtype(old)
        torch.backends.cuda.matmul.allow_tf32 = old_tf32


class State(NamedTuple):
    """A frame's pose state after it ran: the odometry step (pose_c2l),
    the odometry pose, the odometry-to-map correction and the mapped
    pose."""
    c2l: Pose
    odom: Pose
    o2m: Pose
    map: Pose


class Estimate(NamedTuple):
    scan: ScanFeatures
    step: Pose        # the frame's odometry step (identity on a first)
    map: Pose         # its mapped pose


def _finite(p: Pose) -> Tensor:
    return torch.isfinite(p.t).all() & torch.isfinite(p.q).all()


def _grouped(pb: PointBatch, leaf: float, capacity: int, key_world: Tensor,
             cell_size: float, group_budget: int, rows: PointBatch):
    capacity = min(capacity, pb.xyz.shape[-2])
    idx, valid, gid, rep_pos = voxel_downsample_grouped_idx(
        pb.xyz, pb.mask, leaf, capacity, key_world, cell_size, group_budget)
    return rows.take(idx, valid), vm.QueryGroups(gid=gid, rep_pos=rep_pos)


def query_clouds(cfg: FrameConfig, scan: ScanFeatures, guess: Pose,
                 step: Pose):
    """The two query clouds (less-sharp at the line leaf, less-flat at the
    plane leaf), deskewed with ``step`` where the configuration says so,
    downsampled and grouped by their world positions at ``guess``."""
    mc = cfg.mapping
    out = []
    for pb, leaf, cap in ((scan.corner_less_sharp, mc.line_resolution,
                           mc.corner_query_points),
                          (scan.surf_less_flat, mc.plane_resolution,
                           mc.max_query_points)):
        rows = pb
        if cfg.odometry.motion_deskew:
            rows = undistort_from_motion(pb, step, cfg.features.scan_period)
        out.append(_grouped(pb, leaf, cap, guess.apply(rows.xyz),
                            mc.map_cell_size, mc.gather_groups, rows))
    return out


class Replay:
    """One session of the frame from empty maps. ``batched``: the batched
    pipeline's rules (no finite-pose watchdogs, no map-size gate on the
    scan-to-map rounds); else the single pipeline's."""

    def __init__(self, cfg: FrameConfig, device, batched: bool):
        mc = cfg.mapping
        self.cfg, self.device, self.batched = cfg, device, batched
        self.corner_map = vm.create_map(mc.map_table_size,
                                        mc.map_cell_capacity,
                                        mc.map_cell_size, mc.line_resolution,
                                        device=device)
        self.surf_map = vm.create_map(mc.map_table_size, mc.map_cell_capacity,
                                      mc.map_cell_size, mc.plane_resolution,
                                      device=device)
        ident = Pose.identity(device)
        self.state = State(ident, ident, ident, ident)
        self.prev: Optional[ScanFeatures] = None
        self.frames = 0

    def scan(self, img: RingImage, scan_time: float) -> ScanFeatures:
        dt = torch.get_default_dtype()
        img = RingImage(img.xyz.to(self.device, dt),
                        img.rel_time.to(self.device, dt),
                        img.mask.to(self.device))
        t = torch.full((), scan_time, device=self.device)
        return extract_features(img, t, self.cfg.features)

    def frame(self, scan: ScanFeatures) -> Estimate:
        """The frame's odometry step and mapped pose from the state."""
        cfg, st = self.cfg, self.state
        first = self.prev is None
        prev = scan if first else self.prev
        odo = odometry.match_scan2scan(prev, scan, st.c2l, cfg.odometry)
        if first:
            step = Pose.identity(self.device)
        else:
            use = odo.ok if self.batched else odo.ok & _finite(
                odo.pose_curr2last)
            step = select_pose(use, odo.pose_curr2last, st.c2l)
        guess = st.o2m.compose(st.odom.compose(step))
        (cq, cg), (sq, sg) = query_clouds(cfg, scan, guess, step)
        pose, ok = mapping.match_scan2map(
            self.corner_map, self.surf_map, cq, sq, guess, cfg.mapping, cg,
            sg, map_gate=not self.batched)
        if not self.batched:
            ok = ok & _finite(pose)
        return Estimate(scan, step, select_pose(ok, pose, guess))

    def advance(self, scan: ScanFeatures, st: State) -> None:
        """Insert the frame's query clouds at the mapped pose of ``st`` (the
        clouds deskewed with its step and grouped at its guess), evict on
        the period, and take ``st`` as the state."""
        cfg, mc = self.cfg, self.cfg.mapping
        first = self.prev is None
        step = Pose.identity(self.device) if first else st.c2l
        guess = self.state.o2m.compose(st.odom)
        (cq, _), (sq, _) = query_clouds(cfg, scan, guess, step)
        if not (first and cfg.odometry.motion_deskew):
            maps = []
            for vmap, pb in ((self.corner_map, cq), (self.surf_map, sq)):
                w = pb.transform(st.map)
                mask = w.mask & torch.isfinite(w.xyz).all(dim=-1)
                maps.append(vm.insert(vmap, w.xyz, mask))
            self.corner_map, self.surf_map = maps
        self.prev = scan
        self.frames += 1
        if mc.map_evict_period > 0 and \
                self.frames % mc.map_evict_period == 0:
            self.corner_map = vm.evict_far(self.corner_map, st.map.t,
                                           mc.map_evict_radius)
            self.surf_map = vm.evict_far(self.surf_map, st.map.t,
                                         mc.map_evict_radius)
        self.state = st

    def own_state(self, est: Estimate) -> State:
        """The state the frame's own estimate leads to."""
        odom = self.state.odom.compose(est.step)
        c2l = self.state.c2l if self.prev is None else est.step
        return State(c2l, odom, est.map.compose(odom.inverse()), est.map)

    def counts(self):
        """Points held by the corner and the surface map."""
        return (int(self.corner_map.total_points()),
                int(self.surf_map.total_points()))
