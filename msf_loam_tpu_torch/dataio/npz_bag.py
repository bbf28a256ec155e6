"""Multi-sensor stream container ("bag") and timestamp-ordered replay.

The port's copy of the JAX package's ``dataio/npz_bag.py`` (same file
layout, so bags cross between the packages). A bag is one compressed npz
holding the scan, IMU and odometry streams; ``replay()`` yields messages
in global timestamp order (the reference's offline rosbag replay) and
``replay_realtime()`` simulates the online mode: messages arrive on the
wall clock and scans are DROPPED when the consumer falls behind (the
reference's backlog shedding).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass
class ScanMsg:
    time: float
    xyz: np.ndarray       # (N, 3)
    ring: np.ndarray      # (N,)


@dataclasses.dataclass
class ImuMsg:
    time: float
    acc: np.ndarray       # (3,)
    gyr: np.ndarray       # (3,)


@dataclasses.dataclass
class OdomMsg:
    time: float
    t: np.ndarray         # (3,)
    q_wxyz: np.ndarray    # (4,)


Msg = Union[ScanMsg, ImuMsg, OdomMsg]


class BagWriter:
    def __init__(self) -> None:
        self._scan_t: List[float] = []
        self._scan_xyz: List[np.ndarray] = []
        self._scan_ring: List[np.ndarray] = []
        self._imu: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._odom: List[Tuple[float, np.ndarray, np.ndarray]] = []

    def add_scan(self, t: float, xyz: np.ndarray, ring: np.ndarray) -> None:
        self._scan_t.append(t)
        self._scan_xyz.append(np.asarray(xyz, np.float32))
        self._scan_ring.append(np.asarray(ring, np.int32))

    def add_imu(self, t: float, acc, gyr) -> None:
        self._imu.append((t, np.asarray(acc, np.float64),
                          np.asarray(gyr, np.float64)))

    def add_odom(self, t: float, trans, q_wxyz) -> None:
        self._odom.append((t, np.asarray(trans, np.float64),
                           np.asarray(q_wxyz, np.float64)))

    def save(self, path: str) -> None:
        # ragged scans stored flattened + offsets
        counts = np.asarray([len(x) for x in self._scan_xyz], np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        payload = dict(
            scan_times=np.asarray(self._scan_t),
            scan_offsets=offsets,
            scan_xyz=(np.concatenate(self._scan_xyz)
                      if self._scan_xyz else np.zeros((0, 3), np.float32)),
            scan_ring=(np.concatenate(self._scan_ring)
                       if self._scan_ring else np.zeros((0,), np.int32)),
            imu_times=np.asarray([x[0] for x in self._imu]),
            imu_acc=np.asarray([x[1] for x in self._imu]).reshape(-1, 3),
            imu_gyr=np.asarray([x[2] for x in self._imu]).reshape(-1, 3),
            odom_times=np.asarray([x[0] for x in self._odom]),
            odom_t=np.asarray([x[1] for x in self._odom]).reshape(-1, 3),
            odom_q=np.asarray([x[2] for x in self._odom]).reshape(-1, 4),
        )
        np.savez_compressed(path, **payload)


class Bag:
    def __init__(self, path: str):
        # every array is read once: an NpzFile inflates an array again on
        # each access, which made a replay re-read the whole scan stream
        # for every message
        with np.load(path) as z:
            self._z = {k: z[k] for k in z.files}

    @property
    def n_scans(self) -> int:
        return len(self._z["scan_times"])

    def scan(self, i: int) -> ScanMsg:
        o = self._z["scan_offsets"]
        return ScanMsg(
            time=float(self._z["scan_times"][i]),
            xyz=self._z["scan_xyz"][o[i]:o[i + 1]],
            ring=self._z["scan_ring"][o[i]:o[i + 1]],
        )

    def replay(self) -> Iterator[Msg]:
        """All messages in global timestamp order (offline mode)."""
        z = self._z
        streams = [
            (z["scan_times"], "scan"),
            (z["imu_times"], "imu"),
            (z["odom_times"], "odom"),
        ]
        tagged = []
        for times, kind in streams:
            tagged.extend((float(t), kind, i) for i, t in enumerate(times))
        tagged.sort()
        for t, kind, i in tagged:
            if kind == "scan":
                yield self.scan(i)
            elif kind == "imu":
                yield ImuMsg(t, self._z["imu_acc"][i], self._z["imu_gyr"][i])
            else:
                yield OdomMsg(t, self._z["odom_t"][i], self._z["odom_q"][i])

    def replay_realtime(self, speed: float = 1.0,
                        busy_until=None) -> Iterator[Tuple[Msg, bool]]:
        """Online-mode simulation: yields (msg, dropped). A scan is marked
        dropped when the consumer (``busy_until() -> wall time``) is still
        behind when the next scan arrives. IMU messages are never
        dropped."""
        t0_wall = time.perf_counter()
        msgs = list(self.replay())
        if not msgs:
            return
        t0_msg = msgs[0].time
        for m in msgs:
            target = t0_wall + (m.time - t0_msg) / speed
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            dropped = False
            if isinstance(m, ScanMsg) and busy_until is not None:
                dropped = busy_until() > time.perf_counter()
            yield m, dropped


def _quat(R: np.ndarray) -> torch.Tensor:
    """A rotation matrix's quaternion, computed in float32 on the CPU."""
    from msf_loam_tpu_torch.core.se3 import matrix_to_quat
    return matrix_to_quat(torch.as_tensor(np.asarray(R),
                                          dtype=torch.float32))


def bag_from_kitti(kitti_root: str, sequence: str, out_path: str,
                   n_rings: int = 64, max_frames: Optional[int] = None,
                   imu_rate: float = 0.0, latency: float = 0.0) -> None:
    """KITTI sequence -> bag (the kitti_helper workflow, minus ROS).

    With ``imu_rate`` > 0 synthesizes a consistent gyro/accel stream by
    differentiating the ground-truth poses (KITTI odometry has no IMU).
    ``latency`` re-stamps scans with a simulated sensor latency.
    """
    from msf_loam_tpu_torch.dataio.kitti import KittiSequence

    seq = KittiSequence(kitti_root, sequence, n_rings=n_rings)
    end = min(len(seq), max_frames or len(seq))
    w = BagWriter()
    for f in seq.frames(0, end):
        w.add_scan(f.time + latency, f.xyz, f.ring)
        if f.gt_pose is not None:
            w.add_odom(f.time, f.gt_pose[:3, 3],
                       _quat(f.gt_pose[:3, :3]).numpy())
    if imu_rate > 0 and seq.gt_poses is not None:
        _synthesize_imu(w, seq, end, imu_rate)
    w.save(out_path)


def _synthesize_imu(w: BagWriter, seq, end: int, rate: float,
                    gravity=np.array([0.0, 0.0, 9.81])) -> None:
    """Finite-difference ground-truth poses into a plausible IMU stream
    (quaternion algebra in float32 on the CPU, as the JAX package does)."""
    from msf_loam_tpu_torch.core.se3 import (quat_conjugate, quat_log,
                                             quat_multiply, quat_rotate)

    times = seq.times[:end]
    poses = seq.gt_poses[:end]
    if len(times) < 3:
        return
    # spline-free: sample piecewise-linear velocity / angular rate
    dt_frame = np.diff(times)
    v = np.diff(poses[:, :3, 3], axis=0) / dt_frame[:, None]
    t_imu = np.arange(times[0], times[-1], 1.0 / rate)
    for t in t_imu:
        i = min(int(np.searchsorted(times, t, side="right")) - 1,
                len(times) - 2)
        # angular velocity from the bracketing frames' relative rotation
        qi = _quat(poses[i, :3, :3])
        qj = _quat(poses[i + 1, :3, :3])
        w_body = quat_log(quat_multiply(quat_conjugate(qi), qj)).numpy() \
            / max(dt_frame[i], 1e-6)
        # acceleration: world accel (finite diff of v) + gravity, body frame
        a_world = ((v[min(i + 1, len(v) - 1)] - v[max(i - 1, 0)])
                   / max(times[min(i + 1, len(times) - 1)]
                         - times[max(i - 1, 0)], 1e-6))
        acc_body = quat_rotate(quat_conjugate(qi), torch.as_tensor(
            a_world + gravity, dtype=torch.float32)).numpy()
        w.add_imu(float(t), acc_body, w_body)
