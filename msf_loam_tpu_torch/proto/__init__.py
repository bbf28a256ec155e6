"""Protobuf trajectory / IMU record, wire-compatible with the reference.

The port's copy of the JAX package's ``proto/`` codec. The reference
serializes ``PbData`` (trajectory + IMU stream) to ``trajectory.pbstream``
at shutdown and its calibration tool reads it back; ``msg.proto`` /
``config.proto`` here carry the same messages, field numbers and types.

The port's schemas live in their own proto package (``msf_loam_tpu_torch``)
and file path (``msf_loam_tpu_torch/proto/msg.proto``), and the generated
modules are committed and imported by package-qualified name. So this
codec and the JAX package's (which registers ``msg.proto`` in package
``msf_loam_tpu`` in the default descriptor pool) load side by side in one
process, and a record written by either reads back in the other byte for
byte. Regenerate after editing a schema, from the repository root:

    protoc -I. --python_out=. msf_loam_tpu_torch/proto/msg.proto \\
        msf_loam_tpu_torch/proto/config.proto

``available()`` is False where the protobuf runtime is missing; callers
then keep the npz trajectory only.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _msg_pb2():
    from msf_loam_tpu_torch.proto import msg_pb2
    return msg_pb2


def available() -> bool:
    try:
        _msg_pb2()
    except ImportError:
        return False
    return True


def _to_universal_ns100(t_seconds: np.ndarray) -> np.ndarray:
    """Seconds -> the reference's uint64 'universal' ticks (100 ns)."""
    return np.round(np.asarray(t_seconds, np.float64) * 1e7).astype(np.uint64)


def _from_universal(ticks) -> float:
    return float(ticks) / 1e7


def write_pbstream(path: str, times: np.ndarray, t: np.ndarray,
                   q_wxyz: np.ndarray,
                   imu: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Serialize a PbData record (trajectory + optional IMU stream)."""
    d = _msg_pb2().PbData()
    for i, ticks in enumerate(_to_universal_ns100(times)):
        od = d.odom_datas.add()
        od.timestamp = int(ticks)
        od.pose.translation.x = float(t[i, 0])
        od.pose.translation.y = float(t[i, 1])
        od.pose.translation.z = float(t[i, 2])
        od.pose.rotation.w = float(q_wxyz[i, 0])
        od.pose.rotation.x = float(q_wxyz[i, 1])
        od.pose.rotation.y = float(q_wxyz[i, 2])
        od.pose.rotation.z = float(q_wxyz[i, 3])
    if imu is not None:
        gyr = imu["angular_velocity"]
        acc = imu.get("linear_acceleration", np.zeros_like(gyr))
        for i, ticks in enumerate(_to_universal_ns100(imu["times"])):
            im = d.imu_datas.add()
            im.timestamp = int(ticks)
            im.angular_velocity.x = float(gyr[i, 0])
            im.angular_velocity.y = float(gyr[i, 1])
            im.angular_velocity.z = float(gyr[i, 2])
            im.linear_acceleration.x = float(acc[i, 0])
            im.linear_acceleration.y = float(acc[i, 1])
            im.linear_acceleration.z = float(acc[i, 2])
    with open(path, "wb") as f:
        f.write(d.SerializeToString())


def read_pbstream(path: str) -> Dict[str, np.ndarray]:
    """Parse a PbData record into the npz-trajectory dict layout."""
    d = _msg_pb2().PbData()
    with open(path, "rb") as f:
        d.ParseFromString(f.read())
    n = len(d.odom_datas)
    times = np.zeros(n)
    t = np.zeros((n, 3))
    q = np.zeros((n, 4))
    for i, od in enumerate(d.odom_datas):
        times[i] = _from_universal(od.timestamp)
        t[i] = [od.pose.translation.x, od.pose.translation.y,
                od.pose.translation.z]
        q[i] = [od.pose.rotation.w, od.pose.rotation.x,
                od.pose.rotation.y, od.pose.rotation.z]
    out = {"times": times, "translation": t, "rotation_wxyz": q}
    m = len(d.imu_datas)
    if m:
        it = np.zeros(m)
        gyr = np.zeros((m, 3))
        acc = np.zeros((m, 3))
        for i, im in enumerate(d.imu_datas):
            it[i] = _from_universal(im.timestamp)
            gyr[i] = [im.angular_velocity.x, im.angular_velocity.y,
                      im.angular_velocity.z]
            acc[i] = [im.linear_acceleration.x, im.linear_acceleration.y,
                      im.linear_acceleration.z]
        out.update({"imu_times": it, "imu_angular_velocity": gyr,
                    "imu_linear_acceleration": acc})
    return out
