"""The benchmark of ``msf_loam_tpu_torch`` on one H100.

    python3 portbench/run.py --workload kitti_hdl64.stream --seed 7 \\
        --seconds 10 --trace 0

Run from the root of a checkout. ``--workload`` names a cell of
``BENCHMARK.json``; its configuration (``portbench/configs/<config>.json``)
and traffic (``portbench/traffic/<traffic>.json``) are found by name, and
each metric the cell reports by its reader, ``portbench/metrics/<metric>.py``.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (the window untraced, then a traced stretch). Every run
checks the frames it produced against the plain reference
(``portbench/check.py``, ``portbench/ref/``) and prints each number
compared beside its limit, last on standard error
and last in the result: the JSON object on the last line of standard
output. Exits with 2 and prints no result without the CUDA devices the
cell asks for, and with 3 if JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "msf_loam_tpu"}


def use_root() -> None:
    """Import from the checkout's root: a script's own directory
    (portbench/) leads ``sys.path``, and its modules live in a package."""
    here = os.path.join(ROOT, "portbench")
    if sys.path and os.path.abspath(sys.path[0] or ".") == here:
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(root, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        self.chips = self.workload["chips"]
        self.config = load_json(root, "portbench", "configs",
                                self.workload["config"] + ".json")
        self.traffic = load_json(root, "portbench", "traffic",
                                 self.workload["traffic"] + ".json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.root = root

    def reader(self, metric: str):
        path = os.path.join(self.root, "portbench", "metrics",
                            metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def fix_host_threads(n: int) -> None:
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = str(n)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            sessions=None, numbers=None):
    """Runs the cell and returns (result dict, the checks' lines).
    ``sessions``: a function that puts other sessions in the program's
    place before the check (a control); ``numbers``: a dict that gets
    every number of the check, those held to no limit too."""
    import torch

    from portbench import drive

    torch.set_num_threads(cell.config["host_threads"])
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: cell.reader(m["name"]) for m in metrics}
    device_window = any(getattr(r, "NEEDS_WINDOW_DEVICE_TRACE", False)
                        for r in readers.values())
    t_import = time.perf_counter() - T_START
    if device.type == "cuda":
        from msf_loam_tpu_torch import kernels
        kernels.build_all()
    t_build = time.perf_counter() - T_START
    run, feed = drive.drive(cell.config, cell.traffic, seed, seconds,
                            trace, device_window, device, T_START)
    got = drive.judge(feed, seed, cell.config, cell.traffic, device,
                      sessions)
    if numbers is not None:
        numbers.update(got["numbers"])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        print("portbench: the run imported " + ", ".join(bad),
              file=sys.stderr)
        raise SystemExit(3)

    out_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cell.traffic["check"]["limits"]
    checks = {k: {"value": got["numbers"][k], "limit": v}
              for k, v in limits.items()}
    correct = got["frames_compared"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": run.scans,
              "failed": got["numbers"]["not_finite"],
              "metrics": out_metrics,
              "device": dev}
    if trace and run.stretch is not None:
        dev["busy_s"] = run.stretch.busy_s()
        dev["window_s"] = run.stretch.window_s
        result["breakdown"] = {"device_ops": run.stretch.top_device_ops(),
                               "idle_gaps": run.stretch.idle_gaps()}
    result["checks"] = checks
    phases = dict(imports=t_import, kernels=t_build, **run.setup_phases,
                  setup=run.setup_s)
    lines = ["set-up (s since start): " + ", ".join(
        f"{k} {v:.2f}" for k, v in phases.items())]
    if run.window_trace is not None:
        tr = run.window_trace
        lines.append(f"window: {tr.n_ops} device operations, "
                     f"{tr.device_s():.6f} s; the harness's inputs "
                     f"{len(tr.harness_ops)} operations, "
                     f"{sum(d for _, _, d in tr.harness_ops) * 1e-9:.6f} s "
                     f"(left out)")
        lines.append("window's top device ops (s): " + json.dumps(
            tr.top_device_ops(12)))
    lines.append(f"reference: {got['frames_compared']} frames of "
                 f"{got['sessions']} session(s) compared in "
                 f"{got['seconds']:.2f} s")
    lines += [f"largest {k}: {v}" for k, v in got["where"].items()]
    lines += [f"reading {k}: {v!r} (this cell holds it to no limit)"
              for k, v in got["numbers"].items() if k not in checks]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    use_root()
    cell = Cell(args.workload)
    fix_host_threads(cell.config["host_threads"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
