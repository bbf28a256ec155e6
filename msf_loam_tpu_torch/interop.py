"""State carried between the JAX package and the port, as numpy arrays.

The JAX package's state — voxel hash maps, poses, point batches, scan
features and ring images — is this system's "weights". These functions
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
from msf_loam_tpu_torch.slam.voxel_map import VoxelHashMap


def _t(a, dtype, device) -> torch.Tensor:
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


def to_numpy(x: Any) -> Dict[str, Any]:
    """A port container (NamedTuple of tensors, nested) as a dict of numpy
    arrays / nested dicts; plain numbers pass through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "_fields"):
        return {f: to_numpy(getattr(x, f)) for f in x._fields}
    return x
