"""Mid-run checkpoint and resume of a ``SlamPipeline`` (port of the JAX
package's ``slam/checkpoint.py``).

A snapshot holds the whole pipeline state — both voxel maps, the pose
chain, the IMU estimator (velocity, gravity, biases, initialisation flag
and the window of mapped states) and the trajectory so far — in one
compressed ``.npz``, written to a temporary file and renamed over the
target, so a crash never leaves a torn file. The keys, dtypes and the
JSON encoding of the estimator window are the JAX package's, so a file
written by either package loads into the other. The previous scan is not
saved: a resumed pipeline takes it from the caller (``pipe.prev_scan``),
or treats its next frame as a first one.

``save_sharded_checkpoint`` / ``load_sharded_checkpoint`` do the same for
the sharded pipeline (``parallel.sharded_pipeline``): each rank's map
shards under their global slot offsets, in the JAX package's layout.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import TYPE_CHECKING

import numpy as np
import torch

from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.slam.voxel_map import EMPTY_COORD

if TYPE_CHECKING:
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline

_MAPS = (("cmap", "corner_map"), ("smap", "surf_map"))
_POSES = (("pose_odom", "pose_odom"), ("pose_c2l", "pose_curr2last"),
          ("pose_o2m", "pose_odom2map"), ("pose_map", "pose_map"))
_VECTORS = ("velocity", "gravity", "bias_acc", "bias_gyr")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _atomic_savez(path: str, payload: dict) -> None:
    """``np.savez_compressed`` to a temporary file beside ``path``, then an
    atomic rename (the temporary name keeps the ``.npz`` suffix, or numpy
    would append one)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _state_json(st: dict) -> dict:
    """A mapped state without its preintegration (which only feeds the
    bias solve; the solve skips until the window refills), tensors as
    lists."""
    return {k: (v.detach().cpu().tolist() if isinstance(v, torch.Tensor)
                else v) for k, v in st.items() if k != "pre"}


def save_checkpoint(pipe: "SlamPipeline", path: str) -> None:
    payload = {"frame_idx": np.int64(pipe.frame_idx)}
    for key, attr in _POSES:
        pose = getattr(pipe, attr)
        payload[f"{key}_t"] = _np(pose.t)
        payload[f"{key}_q"] = _np(pose.q)
    for name in _VECTORS:
        payload[name] = _np(getattr(pipe, name))
    payload["is_initialized"] = np.bool_(pipe.is_initialized)
    for pref, attr in _MAPS:
        m = getattr(pipe, attr)
        payload[f"{pref}_points"] = _np(m.points)
        payload[f"{pref}_keys"] = _np(m.leaf_key)
        payload[f"{pref}_count"] = _np(m.count)
        payload[f"{pref}_nobs"] = _np(m.n_obs)
    payload["traj"] = pipe.trajectory() if pipe.results else np.zeros((0, 8))
    payload["states_json"] = np.frombuffer(json.dumps(
        [_state_json(s) for s in pipe._states]).encode(), dtype=np.uint8)
    _atomic_savez(path, payload)


def load_checkpoint(pipe: "SlamPipeline", path: str) -> None:
    """Restore a snapshot into ``pipe`` in place, on its device. The
    trajectory comes back as results whose odometry and map poses are both
    the saved map pose."""
    from msf_loam_tpu_torch.slam.pipeline import FrameResult

    dev = pipe.device

    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    def i32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    with np.load(path) as z:
        pipe.frame_idx = int(z["frame_idx"])
        for key, attr in _POSES:
            setattr(pipe, attr, Pose(f32(z[f"{key}_t"]), f32(z[f"{key}_q"])))
        pipe.velocity = f32(z["velocity"])
        pipe.gravity = f32(z["gravity"])
        if "bias_acc" in z.files:
            pipe.bias_acc = f32(z["bias_acc"])
            pipe.bias_gyr = f32(z["bias_gyr"])
        pipe.is_initialized = bool(z["is_initialized"])
        for pref, attr in _MAPS:
            count = i32(z[f"{pref}_count"])
            points = f32(z[f"{pref}_points"])
            # the EMPTY_COORD tail past each slot's count (snapshots
            # written before that invariant hold zeros there)
            occ = torch.arange(points.shape[1], device=dev)[None, :] \
                < count[:, None]
            points = torch.where(occ[..., None], points,
                                 torch.full_like(points, EMPTY_COORD))
            setattr(pipe, attr, getattr(pipe, attr)._replace(
                points=points, leaf_key=i32(z[f"{pref}_keys"]), count=count,
                n_obs=f32(z[f"{pref}_nobs"])))
        states = json.loads(bytes(z["states_json"]).decode() or "[]")
        pipe._states = [{k: (f32(v) if isinstance(v, list) else v)
                         for k, v in s.items()} for s in states]
        pipe.results = [
            FrameResult(time=float(r[0]),
                        odom_pose=Pose(f32(r[1:4]), f32(r[4:8])),
                        map_pose=Pose(f32(r[1:4]), f32(r[4:8])),
                        n_correspondences=0.0, ok=True)
            for r in z["traj"]]


_MAP_FIELDS = ("points", "leaf_key", "count", "n_obs")


def _rank_path(pipe, path: str) -> str:
    return f"{path}.proc{pipe.mesh.rank}" if pipe.mesh.world_size > 1 \
        else path


def _slot_offset(pipe) -> int:
    """First global slot of this rank's shard (the maps' shard size times
    the rank's index on the map axis)."""
    return pipe.corner_map.table_size * pipe.mesh.axis("map").index


def save_sharded_checkpoint(pipe, path: str) -> None:
    """Snapshot a ``ShardedSlamPipeline``: each rank writes its map shards,
    keyed ``{cmap,smap}_{field}@{global slot offset}``, and the replicated
    pose chain and trajectory (the JAX package's keys) to
    ``<path>.proc<rank>``, or to ``path`` at world size 1. Resume needs
    the same world size."""
    payload = {"frame_idx": np.int64(pipe.frame_idx)}
    for key, attr in _POSES:
        pose = getattr(pipe, attr)
        payload[f"{key}_t"] = _np(pose.t)
        payload[f"{key}_q"] = _np(pose.q)
    payload["traj"] = pipe.trajectory() if pipe.results else np.zeros((0, 8))
    off = _slot_offset(pipe)
    for pref, attr in _MAPS:
        m = getattr(pipe, attr)
        for field in _MAP_FIELDS:
            payload[f"{pref}_{field}@{off}"] = _np(getattr(m, field))
    _atomic_savez(_rank_path(pipe, path), payload)


def load_sharded_checkpoint(pipe, path: str) -> None:
    """Restore a ``ShardedSlamPipeline`` (built with the same config and
    world size) in place: each rank reads ``<path>.proc<rank>`` where it
    exists, else ``path`` (a file holding every offset, as the JAX
    package's single-process save of a multi-way mesh), and takes only its
    own slot offset."""
    from msf_loam_tpu_torch.slam.pipeline import FrameResult

    dev = pipe.device

    def f32(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    own = _rank_path(pipe, path)
    if not os.path.exists(own):
        own = path
    off = _slot_offset(pipe)
    with np.load(own) as z:
        pipe.frame_idx = int(z["frame_idx"])
        for key, attr in _POSES:
            setattr(pipe, attr, Pose(f32(z[f"{key}_t"]), f32(z[f"{key}_q"])))
        for pref, attr in _MAPS:
            m = getattr(pipe, attr)
            fields = {}
            for field in _MAP_FIELDS:
                cur = getattr(m, field)
                arr = z[f"{pref}_{field}@{off}"]
                if arr.shape != tuple(cur.shape):
                    raise ValueError(
                        f"{own}: {pref}_{field}@{off} has shape {arr.shape}, "
                        f"the pipeline's shard {tuple(cur.shape)}")
                fields[field] = torch.as_tensor(arr, dtype=cur.dtype,
                                                device=dev)
            setattr(pipe, attr, m._replace(**fields))
        pipe.results = [
            FrameResult(time=float(r[0]),
                        odom_pose=Pose(f32(r[1:4]), f32(r[4:8])),
                        map_pose=Pose(f32(r[1:4]), f32(r[4:8])),
                        n_correspondences=0.0, ok=True)
            for r in z["traj"]]
