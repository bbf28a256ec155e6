"""Output artifacts: PLY map export and trajectory serialization.

The port's copy of the JAX package's ``dataio/artifacts.py``: the
gravity-aligned binary PLY map (``msf_loam_cloud.ply``) and the ``.npz``
trajectory record (the ``trajectory.pbstream`` content without protobuf;
``msf_loam_tpu_torch.proto`` writes the reference's wire format). Files
written by either package read back in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def save_ply(path: str, xyz: np.ndarray,
             intensity: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY (pcl::io::savePLYFileBinary analog)."""
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if intensity is not None:
        props.append("property float intensity")
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}", *props, "end_header", ""])
    if intensity is not None:
        data = np.column_stack([xyz.astype("<f4"),
                                intensity.astype("<f4")]).astype("<f4")
    else:
        data = xyz.astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str) -> np.ndarray:
    """Read back a binary PLY written by save_ply (x, y, z only)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path!r}: no end_header line")
            header += line
        lines = header.decode().splitlines()
        n = int(next(l.split()[-1] for l in lines
                     if l.startswith("element vertex")))
        n_props = sum(1 for l in lines if l.startswith("property"))
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, n_props)
    return data[:, :3].copy()


def gravity_align(xyz: np.ndarray, gravity: np.ndarray) -> np.ndarray:
    """Rotate the cloud so gravity maps to +z (FromTwoVectors(G, UnitZ));
    the rotation is computed in float32 on the CPU, as the JAX package
    computes it."""
    from msf_loam_tpu_torch.core.se3 import (quat_from_two_vectors,
                                             quat_to_matrix)

    q = quat_from_two_vectors(
        torch.as_tensor(np.asarray(gravity), dtype=torch.float32),
        torch.tensor([0.0, 0.0, 1.0]))
    R = quat_to_matrix(q).numpy()
    return xyz @ R.T


def save_trajectory(path: str, times: np.ndarray, t: np.ndarray,
                    q_wxyz: np.ndarray,
                    imu: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Trajectory (+ optional IMU record): the pbstream's content as npz
    (PbData, proto/msg.proto)."""
    payload = dict(times=times, translation=t, rotation_wxyz=q_wxyz)
    if imu is not None:
        payload.update({f"imu_{k}": v for k, v in imu.items()})
    np.savez_compressed(path, **payload)


def load_trajectory(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
