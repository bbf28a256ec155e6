"""KITTI sequence -> npz bag converter CLI.

The port's copy of the JAX package's ``apps/kitti_to_bag.py``, the
reference's ``kitti_helper`` analog: converts a KITTI odometry sequence
into the npz bag that ``run_slam --bag`` replays, optionally synthesizing
a consistent IMU stream from the ground-truth poses (KITTI odometry has no
IMU) and re-stamping scans with a simulated sensor latency.

Usage:
  python -m msf_loam_tpu_torch.apps.kitti_to_bag --kitti_root DIR --sequence 00 \
      --output seq00.npz [--imu_rate 400] [--latency 0.02] [--max_frames N]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kitti_root", required=True)
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--output", required=True)
    ap.add_argument("--n_rings", type=int, default=64)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--imu_rate", type=float, default=0.0,
                    help="synthesize IMU at this rate from GT poses")
    ap.add_argument("--latency", type=float, default=0.0,
                    help="re-stamp scans with simulated sensor latency (s)")
    args = ap.parse_args(argv)

    from msf_loam_tpu_torch.dataio.npz_bag import Bag, bag_from_kitti

    bag_from_kitti(args.kitti_root, args.sequence, args.output,
                   n_rings=args.n_rings, max_frames=args.max_frames,
                   imu_rate=args.imu_rate, latency=args.latency)
    bag = Bag(args.output)
    print(json.dumps({"output": args.output, "scans": bag.n_scans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
