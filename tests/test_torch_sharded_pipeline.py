"""The port's sharded pipeline (``parallel/sharded_pipeline.py``) and
``run_slam --map_shards`` on the CPU.

* ``ShardedSlamPipeline`` at world 2 (a gloo world of 2 processes) and at
  world 1 (this process), 4 motion-distorted frames with
  ``motion_deskew`` on at the widths of tests/test_parallel.py's sharded
  test (1024 points a ring, 4096 less-flat, a 4096-slot table): ranks bit
  for bit on every pose; within 5e-3 m of the port's dense pipeline on
  the same association path (``reuse_candidates=False``, the path every
  sharded hook takes) and of the JAX package's; the shards' point counts
  summing to the dense map's within 0.5% or 5 points (the JAX package's
  bounds for sharded against dense, tests/test_parallel.py).
  The JAX reference is its dense ``SlamPipeline`` with
  ``reuse_candidates=False`` and ``fused_corr="on"`` (Pallas in interpret
  mode): the same math as its sharded pipeline at one device, which JAX's
  own test pins to its sharded one, without running interpret-mode Pallas
  inside ``shard_map`` on the CPU mesh.
* ``sharded_lio_frame`` at world 2 on 2 post-initialisation LIO frames
  (tight coupling), each from the dense pipeline's state, within 5e-3 m of
  the port's dense ``lio_frame_core`` on the same path.
* ``run_slam --map_shards 2`` in the world of 2 on a 3-frame KITTI-format
  sequence: its trajectory within 5e-3 m of ``--map_shards 0`` with
  ``reuse_candidates=False``; a world that does not match the shards
  exits naming torchrun.

One JAX compile (the JAX frame); one gloo world of 2, from the module
fixture, whose children import nothing of JAX. Every join has a timeout.
"""

import contextlib
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
N_FRAMES = 4


def _cfg(reuse=False):
    from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                           MsfLoamConfig)
    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=1024, max_less_flat=4096),
        mapping=MappingConfig(map_table_size=1 << 12, map_cell_capacity=16,
                              max_query_points=1024, reuse_candidates=reuse))
    return dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, motion_deskew=True))


def _scans():
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.ops import features as feat_mod
    fcfg = _cfg().features
    world = synthetic.World.corridor(seed=0, size=12.0)
    out = []
    for i in range(N_FRAMES):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.25 * i, 0.05 * i, 0.0]), np.eye(3),
            n_rings=16, pts_per_ring=900, noise=0.004, seed=i,
            linear_vel=[2.5, 0.5, 0.0])
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16, device="cpu")
        out.append(feat_mod.extract_features(
            img, torch.tensor(0.1 * i, dtype=torch.float32), fcfg))
    return out


def _drive(mesh, scans):
    """The sharded pipeline over ``scans``: its trajectory and map size."""
    from msf_loam_tpu_torch.parallel.sharded_pipeline import \
        ShardedSlamPipeline
    pipe = ShardedSlamPipeline(_cfg(), mesh)
    for s in scans:
        pipe.process_scan(s)
    return dict(traj=pipe.trajectory(), points=pipe.map_points(),
                local=int(pipe.corner_map.count.sum()))


# ------------------------------------------------------------ LIO frames
LIO_V0, LIO_YAW = np.array([1.2, 0.4, 0.0]), 0.25


def _lio_pose(t):
    c, s = np.cos(LIO_YAW * t), np.sin(LIO_YAW * t)
    return LIO_V0 * t, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _case_lio(mesh, n_pre=4, n_post=2):
    """Post-init LIO frames: the dense lio_frame_core and sharded_lio_frame
    from the same state (the shards are the dense maps' slot ranges)."""
    from msf_loam_tpu_torch import interop
    from msf_loam_tpu_torch.config import ImuConfig
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.parallel.sharded_pipeline import sharded_lio_frame
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline, lio_frame_core
    base = _cfg()
    cfg = dataclasses.replace(
        base, odometry=dataclasses.replace(base.odometry,
                                           motion_deskew=False),
        imu=ImuConfig(init_frames=3, warmup_msgs=10, max_imu_samples=64,
                      tight_coupling=True))
    pipe = SlamPipeline(cfg, device="cpu")
    t = 0.5
    g = np.array([0.0, 0.0, 9.81])
    while t < 1.0 + (n_pre + n_post) * 0.1 + 0.2:
        _, R = _lio_pose(t)
        pipe.add_imu(t, R.T @ g, np.array([0.0, 0.0, LIO_YAW]))
        t += 1.0 / 400
    world = synthetic.World.corridor(seed=0, size=12.0)
    ax = mesh.axis("map")
    h = cfg.mapping.map_table_size // ax.size
    out = []
    for i in range(n_pre + n_post):
        ts = 1.0 + 0.1 * i
        p, R = _lio_pose(ts)
        xyz, ring = synthetic.simulate_scan(
            world, p, R, n_rings=16, pts_per_ring=900, noise=0.004, seed=i,
            linear_vel=LIO_V0, yaw_rate=LIO_YAW)
        img = preprocess.preprocess_scan(xyz, ring, cfg.features, 16,
                                         device="cpu")
        if i >= n_pre:
            assert pipe.is_initialized
            prev = pipe._states[-1]
            args = (pipe.prev_scan, img, torch.tensor(ts),
                    pipe.pose_curr2last, pipe.pose_odom, pipe.pose_odom2map,
                    torch.tensor(False), *pipe._window(prev["time"], ts),
                    *pipe._window(ts, ts + cfg.features.scan_period),
                    prev["p"], prev["q"], prev["v"], pipe.gravity)
            kw = dict(ba=pipe.bias_acc, bg=pipe.bias_gyr)
            dense = lio_frame_core(cfg, pipe.corner_map, pipe.surf_map,
                                   *args, **kw)
            shards = [interop.map_shard_from_numpy(m, ax.index * h, h,
                                                   device="cpu")
                      for m in (pipe.corner_map, pipe.surf_map)]
            sharded = sharded_lio_frame(mesh, cfg, *shards, *args, **kw)
            out.append(dict(dense=interop.to_numpy(dense[5]),
                            sharded=interop.to_numpy(sharded[5]),
                            vel=(dense[6].numpy(), sharded[6].numpy())))
        pipe.process_ring_image(img, ts)
    return out


# ------------------------------------------------------------ run_slam
def _kitti(root):
    from msf_loam_tpu_torch.dataio import kitti
    if not os.path.exists(os.path.join(root, "sequences")):
        kitti.make_synthetic_kitti_sequence(root, "00", 3, n_rings=16,
                                            pts_per_ring=900)
    return root


def _run_slam(argv):
    from msf_loam_tpu_torch.apps import run_slam
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_slam.main(argv)
    return rc, buf.getvalue()


def _slam_argv(root, out, shards, config=None):
    argv = ["--kitti_root", root, "--n_rings", "16", "--device", "cpu",
            "--quiet", "--output_dir", out, "--map_shards", str(shards)]
    return argv + (["--config", config] if config else [])


def _worker(rank: int, init: str, out_dir: str) -> None:
    """One rank of the gloo world of 2: every world-2 case."""
    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    runtime.initialize(coordinator=init, num_processes=2, process_id=rank,
                       device="cpu", timeout_s=JOIN_S)
    mesh = mesh_mod.make_mesh(n_map=2, device="cpu")
    res = dict(pipe=_drive(mesh, _scans()), lio=_case_lio(mesh))
    root = os.path.join(out_dir, "kitti")
    if rank == 0:
        _kitti(root)
    torch.distributed.barrier()
    out = os.path.join(out_dir, "slam2")
    res["slam"] = _run_slam(_slam_argv(root, out, 2))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    runtime.shutdown()


def _jax_dense(scans):
    """JAX's dense pipeline on the per-round path (module docstring)."""
    import jax.numpy as jnp

    from msf_loam_tpu.config import FeatureConfig as JF
    from msf_loam_tpu.config import MappingConfig as JM
    from msf_loam_tpu.config import MsfLoamConfig as JC
    from msf_loam_tpu.config import OdometryConfig as JO
    from msf_loam_tpu.core.pointcloud import PointBatch as JPB
    from msf_loam_tpu.core.pointcloud import ScanFeatures as JSF
    from msf_loam_tpu.slam.pipeline import SlamPipeline as JPipe
    from msf_loam_tpu_torch.interop import to_numpy
    cfg = JC(features=JF(max_points_per_ring=1024, max_less_flat=4096,
                         fused_picks="off"),
             odometry=JO(fused_corr="on", motion_deskew=True),
             mapping=JM(map_table_size=1 << 12, map_cell_capacity=16,
                        max_query_points=1024, reuse_candidates=False,
                        fused_select="on"))
    pipe = JPipe(cfg)
    for s in scans:
        d = to_numpy(s)
        pb = lambda k: JPB(*(jnp.asarray(d[k][f]) for f in
                             ("xyz", "rel_time", "ring", "mask")))
        pipe.process_scan(JSF(jnp.asarray(d["time"]), pb("full"),
                              pb("corner_sharp"), pb("corner_less_sharp"),
                              pb("surf_flat"), pb("surf_less_flat")))
    return pipe.trajectory(), int(pipe.corner_map.count.sum())


def _world1(scans, tmp):
    """World 1 in this process: the sharded pipeline, the dense
    references, the dense run_slam and the refused mismatch."""
    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline
    dense = {}
    for reuse in (False, True):
        pipe = SlamPipeline(_cfg(reuse), device="cpu")
        for s in scans:
            pipe.process_scan(s)
        dense[reuse] = (pipe.trajectory(), int(pipe.corner_map.count.sum()))
    runtime.initialize(device="cpu", timeout_s=JOIN_S)
    try:
        w1 = _drive(mesh_mod.make_mesh(n_map=1, device="cpu"), scans)
        err = io.StringIO()
        with pytest.raises(SystemExit) as exc, \
                contextlib.redirect_stderr(err):
            _run_slam(_slam_argv(os.path.join(tmp, "none"), tmp, 2))
    finally:
        runtime.shutdown()
    return dict(w1=w1, dense=dense, refused=(exc.value.code, err.getvalue()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("gloo2"))
    init = "file://" + os.path.join(tmp, "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, {!r}); import "
            "test_torch_sharded_pipeline as t; t._worker({{}}, {!r}, {!r})"
            ).format(os.path.dirname(os.path.abspath(__file__)), init, tmp)
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        scans = _scans()
        jax_traj, jax_points = _jax_dense(scans)
        w1 = _world1(scans, str(tmp_path_factory.mktemp("w1")))
        logs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    # run_slam's dense reference, on the per-round path, after the world
    cfg_path = os.path.join(tmp, "per_round.json")
    with open(cfg_path, "w") as f:
        json.dump({"mapping": {"reuse_candidates": False}}, f)
    rc, _ = _run_slam(_slam_argv(os.path.join(tmp, "kitti"),
                                 os.path.join(tmp, "slam0"), 0, cfg_path))
    assert rc == 0
    return dict(ranks=ranks, jax=(jax_traj, jax_points), tmp=tmp, **w1)


def test_world2_pipeline(world):
    """World 2: both ranks bit for bit; within 5e-3 m of the port's dense
    pipeline and of JAX's; the shards' counts sum to the dense map's."""
    r0, r1 = (r["pipe"] for r in world["ranks"])
    np.testing.assert_array_equal(r0["traj"], r1["traj"])
    dense_traj, dense_points = world["dense"][False]
    jax_traj, jax_points = world["jax"]
    np.testing.assert_allclose(r0["traj"][:, 1:4], dense_traj[:, 1:4],
                               atol=5e-3)
    np.testing.assert_allclose(r0["traj"][:, 1:4], jax_traj[:, 1:4],
                               atol=5e-3)
    total = r0["local"] + r1["local"]
    assert total == r0["points"][0]
    assert abs(total - dense_points) <= max(5, 0.005 * dense_points)
    assert abs(total - jax_points) <= max(5, 0.005 * jax_points)
    assert r0["traj"][-1, 1] > 0.6


def test_world1_pipeline(world):
    """World 1: the sharded pipeline equals the dense per-round pipeline
    (the same operations on one rank) and lies within 5e-3 m of JAX's;
    the dense cached path is printed beside it, not gated."""
    w1 = world["w1"]
    dense_traj, dense_points = world["dense"][False]
    np.testing.assert_allclose(w1["traj"], dense_traj, atol=1e-6)
    assert int(w1["points"][0]) == dense_points
    np.testing.assert_allclose(w1["traj"][:, 1:4], world["jax"][0][:, 1:4],
                               atol=5e-3)
    cached = world["dense"][True][0]
    print("world 1 against the dense cached path (m):",
          np.abs(w1["traj"][:, 1:4] - cached[:, 1:4]).max())


def test_sharded_lio_frame(world):
    """sharded_lio_frame at world 2: ranks bit for bit, pose within 5e-3 m
    of the dense lio_frame_core from the same state, velocity within
    1e-2 m/s."""
    a, b = (r["lio"] for r in world["ranks"])
    assert len(a) == 2
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa["sharded"]["t"], fb["sharded"]["t"])
        np.testing.assert_allclose(fa["sharded"]["t"], fa["dense"]["t"],
                                   atol=5e-3)
        np.testing.assert_allclose(fa["sharded"]["q"], fa["dense"]["q"],
                                   atol=5e-3)
        np.testing.assert_allclose(*fa["vel"], atol=1e-2)


def test_run_slam_map_shards(world):
    """run_slam --map_shards 2 at world 2: rank 0 alone prints and writes;
    the trajectory within 5e-3 m of --map_shards 0 on the per-round
    path. A world of 1 with --map_shards 2 exits naming torchrun."""
    (rc0, out0), (rc1, out1) = (r["slam"] for r in world["ranks"])
    assert rc0 == 0 and rc1 == 0
    assert json.loads(out0.strip().splitlines()[-1])["frames"] == 3
    assert out1.strip() == ""
    z2 = np.load(os.path.join(world["tmp"], "slam2", "trajectory.npz"))
    z0 = np.load(os.path.join(world["tmp"], "slam0", "trajectory.npz"))
    np.testing.assert_allclose(z2["translation"], z0["translation"],
                               atol=5e-3)
    code, msg = world["refused"]
    assert code == 2 and "torchrun --nproc_per_node 2" in msg
