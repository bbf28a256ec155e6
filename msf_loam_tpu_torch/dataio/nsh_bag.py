"""NSH-style ROS1 ``.bag`` fixture writer and validator.

The port's copy of ``courtyard_lap``, ``build_nsh_bag`` and
``validate_bag`` from the repository's ``scripts/make_nsh_bag.py``: the
reference's NSH capture's shape (a handheld VLP-16 walk through the
indoor-outdoor campus world with motion-distorted scans, 400 Hz IMU and an
``/odometry_gt`` stream, with a courtyard-loop revisit) written as a real
ROS1 2.0 bag. From the same arguments it writes the same file, byte for
byte, as the script does.

``validate_bag`` runs the reference's ``validate_velodyne_cloud_in_bag.py``
checks (time field present; rings ordered by vertical angle; clockwise
point order in each ring) through this package's reader.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def courtyard_lap() -> np.ndarray:
    """A closed lap inside the NSH campus courtyard (+ a short tail past
    the start so the proximity detector has a revisit)."""
    return np.array([[40.0, 4.0], [52.0, 4.0], [52.0, 14.0],
                     [40.0, 14.0], [40.0, 4.0], [46.0, 4.0]])


def build_nsh_bag(out_path: str, frames: int = 230, rings: int = 16,
                  pts_per_ring: int = 900, speed: float = 1.8,
                  imu_rate: float = 400.0, scan_dt: float = 0.1,
                  seed: int = 0, compression: str = "bz2",
                  chunk_msgs: int = 0, drop_scan_every: int = 0,
                  disorder: bool = False, pool=None) -> dict:
    """Build the NSH-style fixture bag. ``chunk_msgs`` writes a multi-chunk
    bag; ``drop_scan_every=k`` drops every k-th scan message (sensor frame
    loss); ``disorder`` swaps adjacent record pairs and saves WITHOUT
    time-sorting (out-of-order record stamps the npz conversion heals).
    ``pool`` (a ``concurrent.futures`` process pool) ray-casts the scans in
    its processes; the bag is the same, byte for byte."""
    from msf_loam_tpu_torch.core.se3 import matrix_to_quat
    from msf_loam_tpu_torch.dataio import synthetic
    from msf_loam_tpu_torch.dataio.npz_bag import ImuMsg, OdomMsg, ScanMsg
    from msf_loam_tpu_torch.dataio.preprocess import compute_relative_time
    from msf_loam_tpu_torch.dataio.rosbag import RosbagWriter

    world = synthetic.World.nsh_campus(seed=seed)
    path = synthetic.VehiclePath.from_waypoints(courtyard_lap(),
                                                turn_radius=2.0)
    times = np.arange(frames) * scan_dt
    need = speed * times[-1]
    if need > path.total_length:
        raise ValueError(f"route too short: need {need:.0f} m, "
                         f"have {path.total_length:.0f} m")
    st = synthetic.drive_states(path, speed, times)

    # the bag's timeline starts at t0 so the IMU warm-up precedes scan 0
    t0 = 2.0
    w = RosbagWriter()
    imu_t, imu_a, imu_g = synthetic.synthetic_imu(
        path, speed, -1.0, times[-1] + scan_dt + 0.2, rate=imu_rate,
        accel_noise=0.02, gyro_noise=0.002, seed=seed)
    for j in range(len(imu_t)):
        w.add_imu(ImuMsg(time=t0 + imu_t[j], acc=imu_a[j], gyr=imu_g[j]))

    scans = synthetic.simulate_scans(world, [
        (st["p"][i], st["R"][i], dict(
            n_rings=rings, pts_per_ring=pts_per_ring, fov_up=15.0,
            fov_down=-15.0, max_range=80.0, noise=0.004, seed=1000 + i,
            linear_vel=st["v_world"][i], yaw_rate=float(st["yaw_rate"][i])))
        for i in range(frames)], pool)
    for i, (xyz, ring) in enumerate(scans):
        p, R = st["p"][i], st["R"][i]
        # the velodyne stamps per-point time from azimuth
        rel = compute_relative_time(xyz, ring, scan_period=scan_dt)
        w.add_scan(ScanMsg(time=t0 + times[i], xyz=xyz,
                           ring=ring.astype(np.int32)), rel_time=rel)
        q = matrix_to_quat(torch.from_numpy(R.astype(np.float32)))
        w.add_odom(OdomMsg(time=t0 + times[i], t=p.astype(np.float64),
                           q_wxyz=q.numpy().astype(np.float64)))
    if drop_scan_every:
        scan_cid = w._topic_conn["/velodyne_points"]
        kept, si = [], 0
        for m in w._msgs:
            if m[1] == scan_cid:
                si += 1
                if si % drop_scan_every == 0:
                    continue
            kept.append(m)
        w._msgs = kept
    if disorder:
        for j in range(0, len(w._msgs) - 1, 7):
            w._msgs[j], w._msgs[j + 1] = w._msgs[j + 1], w._msgs[j]
        w.save(out_path, compression=compression, chunk_msgs=chunk_msgs,
               sort=False)
    else:
        w.save(out_path, compression=compression, chunk_msgs=chunk_msgs)
    dist = float(np.linalg.norm(np.diff(st["p"], axis=0), axis=1).sum())
    n_scans = frames - (frames // drop_scan_every if drop_scan_every else 0)
    return {"frames": n_scans, "imu_msgs": len(imu_t),
            "route_m": round(dist, 1), "bytes": os.path.getsize(out_path)}


def validate_bag(bag_path: str, max_scans: int = 3) -> dict:
    """The reference's validation semantics: 1. field 'time' exists; 2.
    ring id increases with vertical angle; 3. points within each ring are
    in clockwise order. Raises ValueError on a violation; returns stats."""
    from msf_loam_tpu_torch.dataio.rosbag import PointCloud2, read_messages

    def require(cond, msg):
        if not cond:
            raise ValueError(msg)

    checked = 0
    for topic, _t, raw in read_messages(bag_path, raw=True):
        if topic != "/velodyne_points" or checked >= max_scans:
            continue
        pc = PointCloud2(raw)
        names = [f[0] for f in pc.fields]
        require("time" in names, f"missing 'time' field (have {names})")
        require("ring" in names, f"missing 'ring' field (have {names})")
        scan = pc.to_scan()
        xyz, ring = scan.xyz, scan.ring
        vert = np.degrees(np.arctan2(xyz[:, 2],
                                     np.linalg.norm(xyz[:, :2], axis=1)))
        mean_v = [vert[ring == r].mean() for r in np.unique(ring)
                  if (ring == r).any()]
        require(all(a < b for a, b in zip(mean_v, mean_v[1:])),
                "ring id not ordered by vertical angle")
        for r in np.unique(ring)[:4]:
            az = -np.arctan2(xyz[ring == r, 1], xyz[ring == r, 0])
            d = np.diff(np.unwrap(az))
            frac_cw = float((d > 0).mean())
            require(frac_cw > 0.98, f"ring {r} not clockwise ({frac_cw:.2f})")
        checked += 1
    require(checked > 0, "no /velodyne_points messages found")
    return {"scans_checked": checked}
