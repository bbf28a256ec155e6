"""The check's control, read on the card at a cell's own size.

    python3 portbench/control.py --workload kitti_hdl64.stream \\
        --seeds 11,12,13 --seconds 10 [--no-f64]

For each seed, one run of the cell as a benchmark run makes it; then, on
the sessions it produced, the check's numbers (``portbench/check.py``)
for:

* ``program``: the program as the configuration states it (float32,
  TF32 off): the sound readings;
* ``control``: the plain reference run in the program's place in TF32
  (float32 matrix products with TF32 inputs: the nearest precision below
  float32 with TF32 off), on the same ring images, judged alike;
* ``program_f64``: the program judged by the reference in float64 (a
  witness of how far float32 itself lies from float64).

``--no-f64`` leaves the float64 witness out. Prints one JSON line a
seed. The benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-f64", action="store_true")
    args = ap.parse_args()
    sys.path[0] = ROOT   # not portbench/: its modules live in a package
    from portbench import check
    from portbench import run as bench
    cell = bench.Cell(args.workload)
    bench.fix_host_threads(cell.config["host_threads"])
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    batched = cell.traffic["mode"] == "fleet"
    slam = cell.config["slam"]
    for seed in (int(s) for s in args.seeds.split(",")):
        got = {}

        def keep(sessions):
            got["s"] = sessions
            return sessions
        prog = {}
        res, lines = bench.measure(cell, seed, args.seconds, False, dev,
                                   sessions=keep, numbers=prog)
        print("\n".join(lines), file=sys.stderr)
        out = {"workload": args.workload, "seed": seed,
               "scans": res["attempted"], "correct": res["correct"],
               "program": prog}
        t0 = time.perf_counter()
        ctl = check.own_states(got["s"], slam, dev, batched,
                               torch.float32, tf32=True)
        t1 = time.perf_counter()
        out["control"] = check.compare(ctl, slam, dev, batched)["numbers"]
        out["control_s"] = [t1 - t0, time.perf_counter() - t1]
        if not args.no_f64:
            out["program_f64"] = check.compare(
                got["s"], slam, dev, batched, dtype=torch.float64)["numbers"]
        print(json.dumps(out), flush=True)
        del got, ctl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
