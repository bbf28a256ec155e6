"""State carried between the JAX package and the port, as numpy arrays.

The JAX package's state — voxel hash maps, poses, point batches, scan
features, ring images, the batched pipeline's state, the IMU
estimator (preintegrations, states, the sample buffer) and pose-graph
problems (graph data, loop factors) — is this
system's "weights". These functions
build the port's tensors from any object exposing the JAX containers'
field names with array-like values (for example a JAX NamedTuple after
``jax.tree.map(np.asarray, ...)``), and turn the port's containers back
into numpy, so both implementations can start from one state and be
compared one frame at a time. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from msf_loam_tpu_torch.core.pointcloud import PointBatch, RingImage, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.imu.buffer import ImuBuffer
from msf_loam_tpu_torch.imu.imu_factor import ImuState
from msf_loam_tpu_torch.imu.preintegration import Preintegration
from msf_loam_tpu_torch.slam.batch_pipeline import BatchState
from msf_loam_tpu_torch.slam.posegraph import LoopFactors, PoseGraphData
from msf_loam_tpu_torch.slam.voxel_map import VoxelHashMap


def _t(a, dtype, device) -> torch.Tensor:
    """A copy of ``a`` (array-like, or a port tensor on any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype, copy=True)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def pose_from_numpy(p: Any, device="cuda") -> Pose:
    return Pose(_t(p.t, torch.float32, device), _t(p.q, torch.float32, device))


def point_batch_from_numpy(pb: Any, device="cuda") -> PointBatch:
    return PointBatch(_t(pb.xyz, torch.float32, device),
                      _t(pb.rel_time, torch.float32, device),
                      _t(pb.ring, torch.int32, device),
                      _t(pb.mask, torch.bool, device))


def scan_features_from_numpy(sf: Any, device="cuda") -> ScanFeatures:
    return ScanFeatures(
        time=_t(sf.time, torch.float32, device),
        full=point_batch_from_numpy(sf.full, device),
        corner_sharp=point_batch_from_numpy(sf.corner_sharp, device),
        corner_less_sharp=point_batch_from_numpy(sf.corner_less_sharp, device),
        surf_flat=point_batch_from_numpy(sf.surf_flat, device),
        surf_less_flat=point_batch_from_numpy(sf.surf_less_flat, device))


def ring_image_from_numpy(img: Any, device="cuda") -> RingImage:
    return RingImage(_t(img.xyz, torch.float32, device),
                     _t(img.rel_time, torch.float32, device),
                     _t(img.mask, torch.bool, device))


def map_from_numpy(m: Any, device="cuda") -> VoxelHashMap:
    return VoxelHashMap(points=_t(m.points, torch.float32, device),
                        leaf_key=_t(m.leaf_key, torch.int32, device),
                        count=_t(m.count, torch.int32, device),
                        n_obs=_t(m.n_obs, torch.float32, device),
                        cell_size=float(np.asarray(m.cell_size)),
                        leaf=float(np.asarray(m.leaf)))


def preintegration_from_numpy(pre: Any, device="cuda") -> Preintegration:
    return Preintegration(*(
        _t(getattr(pre, f), torch.int32 if f == "n_samples" else torch.float32,
           device) for f in Preintegration._fields))


def imu_state_from_numpy(s: Any, device="cuda") -> ImuState:
    return ImuState(pose_from_numpy(s.pose, device),
                    *(_t(getattr(s, f), torch.float32, device)
                      for f in ("v", "ba", "bg")))


def imu_buffer_from_numpy(buf: Any) -> ImuBuffer:
    """A copy of a sample buffer exposing ``times`` and the ``_acc`` /
    ``_gyr`` arrays of the JAX package's ImuBuffer."""
    out = ImuBuffer()
    n = len(buf.times)
    for t, a, g in zip(np.asarray(buf.times), np.asarray(buf._acc)[:n],
                       np.asarray(buf._gyr)[:n]):
        out.add(float(t), a, g)
    return out


def load_pipeline_state(pipe: Any, src: Any) -> None:
    """Set a port ``SlamPipeline``'s whole state from a pipeline object
    with the JAX ``SlamPipeline``'s attributes (or from another port
    pipeline, on any device): maps, poses, previous scan,
    frame count and the IMU estimator (velocity, gravity, biases,
    initialisation flag, the mapped states with their preintegrations, and
    the IMU sample buffer)."""
    dev = pipe.device
    pipe.corner_map = map_from_numpy(src.corner_map, dev)
    pipe.surf_map = map_from_numpy(src.surf_map, dev)
    for name in ("pose_odom", "pose_curr2last", "pose_odom2map", "pose_map"):
        setattr(pipe, name, pose_from_numpy(getattr(src, name), dev))
    pipe.prev_scan = None if src.prev_scan is None else \
        scan_features_from_numpy(src.prev_scan, dev)
    pipe.frame_idx = int(src.frame_idx)
    for name in ("velocity", "gravity", "bias_acc", "bias_gyr"):
        setattr(pipe, name, _t(getattr(src, name), torch.float32, dev))
    pipe.is_initialized = bool(src.is_initialized)
    states = []
    for st in src._states:
        d = dict(time=float(st["time"]))
        for f in ("p", "q", "v", "delta_p", "delta_v"):
            d[f] = None if st.get(f) is None else \
                _t(st[f], torch.float32, dev)
        if st.get("pre") is not None:
            d["pre"] = preintegration_from_numpy(st["pre"], dev)
        states.append(d)
    pipe._states = states
    pipe.imu_buffer = imu_buffer_from_numpy(src.imu_buffer)


def to_numpy(x: Any) -> Dict[str, Any]:
    """A port container (NamedTuple of tensors, nested) as a dict of numpy
    arrays / nested dicts; plain numbers pass through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    return x


def batch_state_from_numpy(st: Any, device="cuda"):
    """A port ``BatchState`` from one with the JAX ``BatchState``'s fields
    (fused maps, lane-batched previous features and poses, frame count)."""
    return BatchState(
        corner_map=map_from_numpy(st.corner_map, device),
        surf_map=map_from_numpy(st.surf_map, device),
        prev_feats=scan_features_from_numpy(st.prev_feats, device),
        pose_c2l=pose_from_numpy(st.pose_c2l, device),
        pose_odom=pose_from_numpy(st.pose_odom, device),
        pose_o2m=pose_from_numpy(st.pose_o2m, device),
        frame_idx=int(np.asarray(st.frame_idx)))


def pose_graph_data_from_numpy(d: Any, device="cuda") -> PoseGraphData:
    """A port ``PoseGraphData`` from one with the JAX fields (times,
    relative measurements, GPS ties); indices become int64."""
    return PoseGraphData(
        times=_t(d.times, torch.float32, device),
        rel_meas=pose_from_numpy(d.rel_meas, device),
        rel_valid=_t(d.rel_valid, torch.bool, device),
        gps_xyz=_t(d.gps_xyz, torch.float32, device),
        gps_seg=_t(d.gps_seg, torch.int64, device),
        gps_frac=_t(d.gps_frac, torch.float32, device),
        gps_valid=_t(d.gps_valid, torch.bool, device))


def loop_factors_from_numpy(lf: Any, device="cuda") -> LoopFactors:
    """Port ``LoopFactors`` from padded ones with the JAX fields."""
    return LoopFactors(idx_i=_t(lf.idx_i, torch.int64, device),
                       idx_j=_t(lf.idx_j, torch.int64, device),
                       meas=pose_from_numpy(lf.meas, device),
                       valid=_t(lf.valid, torch.bool, device))
