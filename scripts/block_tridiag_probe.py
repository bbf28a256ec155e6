#!/usr/bin/env python3
"""Why ``block_tridiag``'s time depends on its data: a probe on one GPU.

    python3 scripts/block_tridiag_probe.py

Builds ``msf_loam_tpu_torch/csrc/block_tridiag.cu`` three ways: with the
port's flags; with ``-ftz=true`` added (subnormal inputs and results of
every float operation flushed to zero, so no IEEE division leaves its
fast path for a subnormal); and with its two division sites replaced by
``__fdividef`` (approximate, no slow path at all). It times each on the
ten Gauss-Newton systems that
``optimize_with_loops`` solves on ``chip_smoke.py``'s KITTI-size graph
(4541 poses padded to 8192, 8 loops, m = 49), and on a seeded SPD system
of the same size. For each system it prints the device time of each build
(CUDA events around a batch of launches), the subnormal entries of D, U,
B and of the solution, and how many of the solution's entries the flushed
build changes. The two other builds are experiments only: the port never
uses them, as their results are not those of the plain version.
"""

import ctypes
import os
import subprocess
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REPS = 10


def main():
    import torch
    if not torch.cuda.is_available():
        print("block_tridiag_probe: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from msf_loam_tpu_torch import kernels
    from msf_loam_tpu_torch.config import FeatureConfig, MsfLoamConfig
    from msf_loam_tpu_torch.core import se3
    from msf_loam_tpu_torch.ops import block_tridiag as bt
    from msf_loam_tpu_torch.slam import posegraph as pg

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    kernels.build_all()
    libs = {"port flags": kernels.library("block_tridiag")}
    ftz = os.path.join(kernels.BUILD_DIR, "block_tridiag_ftz_probe.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-ftz=true", "-o",
                    ftz, os.path.join(kernels.CSRC, "block_tridiag.cu")],
                   check=True, capture_output=True)
    libs["-ftz=true"] = ctypes.CDLL(ftz)
    with open(os.path.join(kernels.CSRC, "block_tridiag.cu")) as f:
        src = f.read()
    approx = src.replace("a[i][k] / a[k][k]", "__fdividef(a[i][k], a[k][k])")
    approx = approx.replace("y[k] / a[k][k]", "__fdividef(y[k], a[k][k])")
    assert approx.count("__fdividef") == 2
    src_path = os.path.join(kernels.BUILD_DIR, "block_tridiag_fdividef.cu")
    with open(src_path, "w") as f:
        f.write(approx)
    out = src_path[:-3] + "_probe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                    src_path], check=True, capture_output=True)
    libs["__fdividef"] = ctypes.CDLL(out)
    guard = """__device__ __forceinline__ float div_zero_guard(float a, float b) {
  const bool z = a == 0.0f && b == b && b != 0.0f;
  const float q = (z ? 1.0f : a) / b;
  return z ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                            0x80000000) : q;
}
"""
    zg = src.replace("a[i][k] / a[k][k]", "div_zero_guard(a[i][k], a[k][k])")
    zg = zg.replace("y[k] / a[k][k]", "div_zero_guard(y[k], a[k][k])")
    zg = zg.replace("namespace {\n", "namespace {\n" + guard, 1)
    src_path = os.path.join(kernels.BUILD_DIR, "block_tridiag_zg.cu")
    with open(src_path, "w") as f:
        f.write(zg)
    out = src_path[:-3] + "_probe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                    src_path], check=True, capture_output=True)
    libs["zero guard"] = ctypes.CDLL(out)
    dd = src.replace("a[i][k] / a[k][k]",
                     "(float)((double)a[i][k] / (double)a[k][k])")
    dd = dd.replace("y[k] / a[k][k]", "(float)((double)y[k] / (double)a[k][k])")
    src_path = os.path.join(kernels.BUILD_DIR, "block_tridiag_f64div.cu")
    with open(src_path, "w") as f:
        f.write(dd)
    out = src_path[:-3] + "_probe.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                    src_path], check=True, capture_output=True)
    libs["float64 division"] = ctypes.CDLL(out)

    def use(lib):
        kernels._LIBS["block_tridiag"] = lib
        for k in [k for k in kernels._FUNCS if k.startswith("block_tridiag")]:
            del kernels._FUNCS[k]

    dev = torch.device("cuda")
    c = types.SimpleNamespace(torch=torch, Pose=se3.Pose, pg=pg, dev=dev)
    cfg = MsfLoamConfig(features=FeatureConfig(max_points_per_ring=2048))
    _, poses0, data, loops = cs.pg_problem(c, cs.PG_KITTI_N, cs.PG_LOOPS,
                                           dev)
    systems = []
    solve = pg.solve_block_tridiag_multi

    def record(D, U, B):
        systems.append((f"GN iteration {len(systems) + 1}", D.clone(),
                        U.clone(), B.clone()))
        return solve(D, U, B)
    pg.solve_block_tridiag_multi = record
    try:
        pg.optimize_with_loops(poses0, data, loops, cfg.posegraph,
                               n_iters=10)
    finally:
        pg.solve_block_tridiag_multi = solve
    N, m = systems[0][3].shape[0], systems[0][3].shape[2]
    systems.append(("seeded SPD",) + cs.seeded_tridiag(
        torch, np.random.default_rng(0), N, m, dev))

    def sub(x):
        return int(((x != 0) & (x.abs() < torch.finfo(torch.float32).tiny))
                   .sum())

    def ms(D, U, B):
        return cs.batch_ms(torch, lambda: bt.block_tridiag(D, U, B),
                           reps=REPS)

    print(f"block_tridiag probe, N={N} m={m}, {bt.segments(N)} (L, P), "
          f"batch of {REPS} [{card}]")
    for name, D, U, B in systems:
        out = {}
        for label, lib in libs.items():
            use(lib)
            out[label] = (ms(D, U, B), bt.block_tridiag(D, U, B))
        use(libs["port flags"])
        (t0, X), (t1, Xf) = out["port flags"], out["-ftz=true"]
        print(f"{name}: device {t0:.4f} ms (port flags), {t1:.4f} ms "
              f"(-ftz=true), {out['__fdividef'][0]:.4f} ms (__fdividef), "
              f"{out['zero guard'][0]:.4f} ms (zero guard, equal "
              f"{torch.equal(out['zero guard'][1], X)}), "
              f"{out['float64 division'][0]:.4f} ms (float64 division, "
              f"equal {torch.equal(out['float64 division'][1], X)}); "
              f"subnormal entries D {sub(D)}, U {sub(U)}, "
              f"B {sub(B)}, X {sub(X)}; entries of X the flush changes "
              f"{int((X != Xf).sum())} of {X.numel()} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
