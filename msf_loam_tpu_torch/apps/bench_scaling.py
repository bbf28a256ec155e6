"""Distributed scaling step of the port (the counterpart of the JAX
package's ``apps/bench_scaling.py``), at the world size it runs in.

One step is the JAX harness's ``bench_one``: a sharded-map insert of 2048
points and a 512-query k-NN over the ``map`` axis, a data-parallel
point-to-plane GN over 256 correspondences a rank, and a distributed
block-tridiagonal solve of 8 blocks a rank over the ``data`` axis (weak
scaling: the work grows with the ranks). ``--pipeline`` adds the sharded
pipeline's frames/s at a fixed workload (strong scaling). Rank 0 prints
one JSON line.

Usage:
  python -m msf_loam_tpu_torch.apps.bench_scaling [--device cpu]
  torchrun --nproc_per_node N -m msf_loam_tpu_torch.apps.bench_scaling
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_one(mesh_map, mesh_data, n_iters: int = 3) -> float:
    """Steps/s of one distributed mapping step (module docstring)."""
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.parallel import (data_parallel, distributed_ba,
                                             sharded_map)

    dev = mesh_map.device
    W = mesh_data.world_size
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    H = 1 << 11
    m = sharded_map.create_sharded_map(mesh_map, H, 16, 2.0, 0.4)
    pts = t(rng.uniform(-20, 20, size=(2048, 3)).astype(np.float32))
    q = t(rng.uniform(-18, 18, size=(512, 3)).astype(np.float32))
    ones = torch.ones(2048, dtype=torch.bool, device=dev)
    qmask = ones[:512]
    n_corr = 256 * W
    normals = rng.normal(size=(n_corr, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pw = t(rng.normal(size=(n_corr, 3)).astype(np.float32) * 5)
    N_pose = 8 * W
    D = rng.normal(size=(N_pose, 6, 6)).astype(np.float32)
    D = np.einsum("nij,nkj->nik", D, D) + 8 * np.eye(6, dtype=np.float32)
    U = (rng.normal(size=(N_pose - 1, 6, 6)) * 0.2).astype(np.float32)
    b = rng.normal(size=(N_pose, 6)).astype(np.float32)
    D, U, b = t(D), t(U), t(b)
    pose0 = Pose.identity(dev)

    def step(mm):
        mm = sharded_map.sharded_insert(mesh_map, mm, pts, ones)
        d2, _, _ = sharded_map.sharded_query_knn(mesh_map, mm, q, qmask)
        pose = data_parallel.dp_gauss_newton_plane(
            mesh_data, pose0, pw, pw, t(normals), ones[:1].expand(n_corr),
            n_iters=3)
        x = distributed_ba.distributed_tridiag_solve(mesh_data, D, U, b)
        return mm, d2, pose, x

    mm = step(m)[0]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n_iters):
        mm = step(mm)[0]
    _sync(dev)
    return n_iters / (time.perf_counter() - t0)


def bench_pipeline(mesh, n_frames: int = 6, rings: int = 16,
                   pts: int = 900) -> float:
    """The sharded pipeline's frames/s at a fixed workload (the JAX
    harness's ``bench_pipeline``)."""
    from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                           MsfLoamConfig)
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.parallel.sharded_pipeline import \
        ShardedSlamPipeline

    W = mesh.axis("map").size
    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=1024, max_less_flat=4096),
        mapping=MappingConfig(map_table_size=((1 << 14) // W) * W,
                              map_cell_capacity=32, max_query_points=2048))
    world = synthetic.World.corridor(seed=0, size=14.0)
    imgs = []
    for i in range(n_frames):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.15 * i, 0.05 * i, 0.0]), np.eye(3),
            n_rings=rings, pts_per_ring=pts, noise=0.004, seed=i)
        imgs.append(preprocess.preprocess_scan(xyz, ring, cfg.features,
                                               num_rings=rings,
                                               device=mesh.device))

    def run_once():
        pipe = ShardedSlamPipeline(cfg, mesh)
        for i, img in enumerate(imgs):
            pipe.process_ring_image(img, 0.1 * i)
        _sync(mesh.device)

    run_once()
    t0 = time.perf_counter()
    reps = 2
    for _ in range(reps):
        run_once()
    return n_frames * reps / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pipeline", action="store_true",
                    help="also bench the sharded pipeline's frames/s")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the ranks' device (default cuda: raises without "
                         "CUDA)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    started = not dist.is_initialized()
    runtime.initialize(device=args.device)
    try:
        W = dist.get_world_size()
        mesh_map = mesh_mod.make_mesh(n_map=W, device=args.device)
        mesh_data = mesh_mod.make_mesh(n_map=1, n_data=W, device=args.device)
        out = {"platform": "gpu" if mesh_map.device.type == "cuda"
               else "cpu", "world_size": W,
               "steps_per_sec": bench_one(mesh_map, mesh_data)}
        if args.pipeline:
            out["pipeline_frames_per_sec"] = bench_pipeline(mesh_map)
        if dist.get_rank() == 0:
            print(json.dumps(out))
            if args.json:
                with open(args.json, "w") as f:
                    json.dump(out, f, indent=1)
    finally:
        if started:
            runtime.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
