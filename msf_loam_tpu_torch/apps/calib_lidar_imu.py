"""Offline LiDAR-IMU extrinsic rotation calibration CLI.

The port of the JAX package's ``apps/calib_lidar_imu.py``, the
reference's ``calib_lidar_imu`` tool: loads a recorded trajectory + IMU
artifact (``run_slam``'s npz trajectory or its ``trajectory.pbstream``),
forms lidar rotation deltas over every k-th odometry pair and the
gyro-integrated IMU deltas over the same spans, and runs the hand-eye SVD
solve (``imu.extrinsic_calib``). The quaternion algebra and the solve run
in float32 on the card (``--device cuda``, the default), as the JAX
package's run on its default device; the app raises on a machine without
CUDA, and ``--device cpu`` runs them on the CPU.

Usage:
  python -m msf_loam_tpu_torch.apps.calib_lidar_imu --trajectory traj.npz
  python -m msf_loam_tpu_torch.apps.calib_lidar_imu --trajectory traj.npz \
      --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trajectory", required=True,
                    help="npz with times/rotation_wxyz and imu_* arrays, "
                         "or a .pbstream")
    ap.add_argument("--stride", type=int, default=3,
                    help="use every k-th odometry pair")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the quaternion algebra and the SVD solve "
                         "run")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calib_lidar_imu --device cuda (the default) "
                           "needs a CUDA device; pass --device cpu to run "
                           "on the CPU")
    dev = torch.device(args.device)

    from msf_loam_tpu_torch.core.se3 import quat_conjugate, quat_multiply
    from msf_loam_tpu_torch.dataio.artifacts import load_trajectory
    from msf_loam_tpu_torch.imu.extrinsic_calib import (
        calibrate_extrinsic_rotation, integrate_gyro_rotation)

    if args.trajectory.endswith(".pbstream"):
        from msf_loam_tpu_torch import proto as pbcodec
        data = pbcodec.read_pbstream(args.trajectory)
    else:
        data = load_trajectory(args.trajectory)
    times = data["times"]
    q = torch.as_tensor(data["rotation_wxyz"], dtype=torch.float32,
                        device=dev)
    if "imu_times" not in data:
        print("error: trajectory artifact has no IMU record", file=sys.stderr)
        return 2
    imu_t = data["imu_times"]
    imu_gyr = data["imu_angular_velocity"]

    dq_lidar, dq_imu = [], []
    for i in range(0, len(times) - args.stride, args.stride):
        j = i + args.stride
        ql = quat_multiply(quat_conjugate(q[i]), q[j])
        # gyro integration over [t_i, t_j] on the IMU samples in range
        sel = (imu_t >= times[i]) & (imu_t < times[j])
        if sel.sum() < 2:
            continue
        ts = imu_t[sel]
        dts = np.diff(ts, prepend=times[i]).astype(np.float32)
        qi = integrate_gyro_rotation(
            torch.as_tensor(imu_gyr[sel], dtype=torch.float32, device=dev),
            torch.from_numpy(dts).to(dev),
            torch.ones(len(ts), dtype=torch.bool, device=dev))
        dq_lidar.append(ql)
        dq_imu.append(qi)

    if len(dq_lidar) < 10:
        print(json.dumps({"converged": False,
                          "reason": f"only {len(dq_lidar)} pairs"}))
        return 1

    out = calibrate_extrinsic_rotation(
        torch.stack(dq_lidar), torch.stack(dq_imu),
        torch.ones(len(dq_lidar), dtype=torch.bool, device=dev))
    result = {
        "converged": bool(out.converged),
        "q_ric_wxyz": [round(float(x), 6) for x in out.q_ric],
        "sigma_gate": round(float(out.singular_gate), 4),
        "n_pairs": len(dq_lidar),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
