"""How the fleet cell's B was chosen: one run of ``kitti_hdl64.fleet`` at
another number of lanes, its window untraced and a stretch traced after.

    python3 portbench/sweep.py --lanes 64 --seconds 10

Prints one JSON line: lanes, lane-scans/s over the untraced window, the
traced stretch's device idle share and device ms a lane-scan, and the
peak device memory. The cell takes the smallest B whose idle share is
under 50%. The sweep does not run the check.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    sys.path[0] = ROOT   # not portbench/: its modules live in a package
    from portbench import run as bench
    cell = bench.Cell("kitti_hdl64.fleet")
    bench.fix_host_threads(cell.config["host_threads"])
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from msf_loam_tpu_torch import kernels
    from portbench import drive
    torch.set_num_threads(cell.config["host_threads"])
    kernels.build_all()
    dev = torch.device("cuda", 0)
    traffic = dict(cell.traffic, lanes=args.lanes)
    run, _ = drive.drive(cell.config, traffic, args.seed, args.seconds,
                         True, False, dev, t_start)
    st = run.stretch
    print(json.dumps({
        "lanes": args.lanes, "lane_scans": run.scans,
        "lane_scans_per_s": run.scans / run.wall_s,
        "device_idle_pct": 100.0 * (1.0 - st.busy_s() / st.window_s),
        "device_ms_per_lane_scan": st.device_s() / run.stretch_scans * 1e3,
        "memory_peak_bytes": run.memory_peak_bytes,
        "setup_s": run.setup_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
