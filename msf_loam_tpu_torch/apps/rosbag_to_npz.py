"""Convert a ROS1 .bag to the engine's native npz-bag.

The port's copy of the JAX package's ``apps/rosbag_to_npz.py``, the
rosbag-free analog of the reference's offline ingest
(msf_loam_node.cc:448-459): reads /velodyne_points, /imu, /odometry_gt
with the pure-Python parser (dataio/rosbag.py) and writes one npz-bag for
``run_slam --bag``. ``--latency`` re-stamps scans with a simulated sensor
latency (the reference's 20 ms).

  python -m msf_loam_tpu_torch.apps.rosbag_to_npz in.bag out.npz \
      [--cloud_topic /velodyne_points] [--imu_topic /imu] \
      [--odom_topic /odometry_gt] [--latency 0.02]
"""

import argparse
import json

from msf_loam_tpu_torch.dataio.rosbag import bag_to_npz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag")
    ap.add_argument("out")
    ap.add_argument("--cloud_topic", default="/velodyne_points")
    ap.add_argument("--imu_topic", default="/imu")
    ap.add_argument("--odom_topic", default="/odometry_gt")
    ap.add_argument("--latency", type=float, default=0.0)
    args = ap.parse_args(argv)
    counts = bag_to_npz(args.bag, args.out,
                        cloud_topic=args.cloud_topic,
                        imu_topic=args.imu_topic,
                        odom_topic=args.odom_topic,
                        latency=args.latency)
    print(json.dumps({"out": args.out, **counts}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
