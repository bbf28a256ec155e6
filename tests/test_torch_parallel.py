"""The port's distribution layer (``msf_loam_tpu_torch/parallel``) on the
CPU: one gloo world of 2 processes runs every module but the pipeline and
returns its results as numpy; the parent process holds them to the port's
dense functions, to each other (ranks bit for bit) and to the JAX
package.

* the sharded map: insert, the packed query pair and evict against the
  dense ``insert``, ``query_knn(_2r)`` and ``evict_far`` on the same points
  (the gathered shards equal the dense table; the merge is exact, so d2 is
  bit-equal and the picks equal);
* ``dp_gauss_newton_plane`` and ``sharded_match_scan2scan`` within 1e-5
  of the dense solves (only the summation order of H and g differs), and
  the warning on query rows that do not divide the axis;
* the distributed tridiagonal and Woodbury solves (condense, gathered
  separator solve, back-substitute) within 1e-5 of the one-launch solve,
  and ``optimize_distributed`` / ``optimize_with_loops_distributed`` at
  N = 64 with GPS every 4th pose within 1e-4 m of the JAX package's on a
  2-way data mesh (the conditioning under which both solvers agree to
  1e-4; ROADMAP C7);
* the sharded checkpoint: a world-2 save and resume within 1e-5 m of the
  uninterrupted run; at world 1, files crossing both ways with the JAX
  package's ``save_sharded_checkpoint`` / ``load_sharded_checkpoint``.

The children import nothing of JAX (this module imports JAX inside the
fixture only). One JAX compile: the two distributed optimisers in one
jitted function. Every join has a timeout.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
N_PG, PG_ITERS = 64, 6


def _pg_problem():
    """A square driven with a 0.02 rad yaw bias a pose, GPS with U(-5, 5)
    cm noise every 4th pose, two loops from ground truth padded to 4:
    numpy (t0, q0, rel_t, rel_q, gps pose indices, gps xyz, loops)."""
    rng = np.random.default_rng(11)
    N = N_PG
    side = N // 4
    heading = (np.arange(N) // side) * (np.pi / 2)
    gt_t = np.concatenate([np.zeros((1, 3)), np.cumsum(np.stack(
        [np.cos(heading[1:]), np.sin(heading[1:]), 0 * heading[1:]], 1),
        0)])
    dyaw = np.diff(heading) + 0.02
    step = np.diff(gt_t, axis=0)
    c, s = np.cos(heading[:-1]), np.sin(heading[:-1])
    rel_t = np.stack([c * step[:, 0] + s * step[:, 1],
                      -s * step[:, 0] + c * step[:, 1], 0 * c], 1)
    p, ys = [np.zeros(3)], [0.0]
    for i in range(N - 1):
        c, s = np.cos(ys[-1]), np.sin(ys[-1])
        p.append(p[-1] + np.array([c * rel_t[i, 0] - s * rel_t[i, 1],
                                   s * rel_t[i, 0] + c * rel_t[i, 1], 0.0]))
        ys.append(ys[-1] + dyaw[i])

    def yq(y):
        y = np.asarray(y)
        return np.stack([np.cos(y / 2), 0 * y, 0 * y, np.sin(y / 2)], 1)
    gi = np.arange(0, N, 4)
    gxyz = gt_t[gi] + rng.uniform(-0.05, 0.05, (len(gi), 3))
    f = lambda a: np.asarray(a, np.float32)
    loops = (np.array([0, 2]), np.array([N - 1, 40]), f(gt_t), f(yq(heading)))
    return (f(np.stack(p)), f(yq(ys)), f(rel_t), f(yq(dyaw)), f(gi),
            f(gxyz), loops)


def _pg_inputs(device="cpu"):
    """The port's (poses0, data, loops) of ``_pg_problem``."""
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.slam import posegraph as pg
    t0, q0, rt, rq, gi, gxyz, (ri, rj, gt, gq) = _pg_problem()
    T = lambda a: torch.as_tensor(a, device=device)
    poses0 = Pose(T(t0), T(q0))
    data = pg.build_graph_data(torch.arange(N_PG, dtype=torch.float32),
                               poses0, T(gi), T(gxyz),
                               torch.ones(len(gi), dtype=torch.bool))
    data = data._replace(rel_meas=Pose(T(rt), T(rq)))
    g = Pose(T(gt), T(gq))
    meas = Pose(g.t[ri], g.q[ri]).inverse().compose(Pose(g.t[rj], g.q[rj]))
    return poses0, data, pg.LoopFactors.pad(ri, rj, meas, to_l=4)


def _scans(n=4):
    """Feature frames of a 16-ring distorted corridor drive (the widths of
    tests/test_parallel.py's sharded-pipeline test, 900 points a ring)."""
    from msf_loam_tpu_torch.config import FeatureConfig
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.ops import features as feat_mod
    fcfg = FeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    world = synthetic.World.corridor(seed=0, size=12.0)
    out = []
    for i in range(n):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.25 * i, 0.05 * i, 0.0]), np.eye(3),
            n_rings=16, pts_per_ring=900, noise=0.004, seed=i,
            linear_vel=[2.5, 0.5, 0.0])
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16, device="cpu")
        out.append(feat_mod.extract_features(
            img, torch.tensor(0.1 * i, dtype=torch.float32), fcfg))
    return fcfg, out


def _pipe_cfg(fcfg):
    import dataclasses

    from msf_loam_tpu_torch.config import MappingConfig, MsfLoamConfig
    cfg = MsfLoamConfig(features=fcfg, mapping=MappingConfig(
        map_table_size=1 << 12, map_cell_capacity=16, max_query_points=1024))
    return dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, motion_deskew=True))


def _np(x):
    """Tensors, NamedTuples of them and plain tuples of either as numpy."""
    from msf_loam_tpu_torch.interop import to_numpy
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_np(a) for a in x)
    return to_numpy(x)


def _case_map(mesh):
    """Sharded insert / gather / query pair / evict against dense."""
    from msf_loam_tpu_torch.parallel import sharded_map as sm
    from msf_loam_tpu_torch.slam import voxel_map as vm
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-9, 9, (3000, 3)).astype(np.float32))
    mask = torch.as_tensor(rng.uniform(size=3000) > 0.1)
    qc = torch.as_tensor(rng.uniform(-8, 8, (300, 3)).astype(np.float32))
    qs = torch.as_tensor(rng.uniform(-8, 8, (500, 3)).astype(np.float32))
    qcm = torch.ones(300, dtype=torch.bool)
    qsm = torch.as_tensor(rng.uniform(size=500) > 0.05)
    H = 256
    out = {}
    for name, leaf in (("c", 0.2), ("s", 0.4)):
        local = sm.create_sharded_map(mesh, H, 16, 2.0, leaf)
        local = sm.sharded_insert(mesh, local, pts, mask)
        local = sm.sharded_insert(mesh, local, pts[:500] + 0.05, mask[:500])
        dense = vm.insert(vm.create_map(H, 16, 2.0, leaf, device="cpu"),
                          pts, mask)
        dense = vm.insert(dense, pts[:500] + 0.05, mask[:500])
        out[name] = (local, dense)
    (lc, dc), (ls, ds) = out["c"], out["s"]
    sel_c, sel_s = sm.sharded_query_pair(mesh, lc, ls, qc, qcm, qs, qsm)
    center = torch.tensor([1.0, -2.0, 0.5])
    ev = sm.sharded_evict_far(mesh, ls, center, 6.0)
    return dict(
        local=_np(lc), gathered=_np(sm.gather_map(mesh, lc)), dense=_np(dc),
        pair=(_np(sel_c), _np(sel_s)),
        dense_pair=(_np(vm.query_knn(dc, qc, qcm, k=5)),
                    _np(vm.query_knn_2r(ds, qs, qsm, k=5, k2=16))),
        single=_np(sm.sharded_query_knn(mesh, ls, qs, qsm, k=5)),
        single2=_np(sm.sharded_query_knn_2r(mesh, ls, qs, qsm)),
        evicted=_np(sm.gather_map(mesh, ev)),
        dense_evicted=_np(vm.evict_far(ds, center, 6.0)),
        points=int(sm.map_points(mesh, lc, ls)[0]))


def _case_gn(mesh_map, mesh_data, scans):
    """DP-GN and the sharded odometry against their dense solves."""
    from msf_loam_tpu_torch.config import OdometryConfig
    from msf_loam_tpu_torch.core.pointcloud import PointBatch
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.ops import gauss_newton as gn
    from msf_loam_tpu_torch.ops import icp_residuals as icp
    from msf_loam_tpu_torch.parallel import data_parallel, sharded_odometry
    from msf_loam_tpu_torch.slam import odometry
    rng = np.random.default_rng(2)
    n = 512
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    pw = torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32) * 5)
    true = Pose(torch.tensor([0.1, -0.05, 0.02]),
                torch.tensor([0.9998, 0.01, -0.01, 0.015]))
    true = Pose(true.t, true.q / true.q.norm())
    cen = true.apply(pw)
    valid = torch.as_tensor(rng.uniform(size=n) > 0.1)
    p0 = Pose.identity("cpu")
    got = data_parallel.dp_gauss_newton_plane(
        mesh_data, p0, pw, cen, torch.as_tensor(nrm), valid, 5)
    # the dense reference: the same damped LU steps over all rows at once
    pose = p0
    for _ in range(5):
        b = icp.plane_residuals(pose, pw, cen, torch.as_tensor(nrm), valid)
        w = gn.huber_weights(b, 0.1)
        H, g, _, n_in = gn.accumulate_normal_eqs([b], [w], 6)
        H = H + 1e-4 * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
        pose = pose.retract(-torch.linalg.solve(H, g))
    oc = OdometryConfig()
    s0, s1 = scans[0], scans[1]
    sharded = sharded_odometry.sharded_match_scan2scan(
        mesh_map, s0, s1, Pose.identity("cpu"), oc)
    dense = odometry.match_scan2scan(s0, s1, Pose.identity("cpu"), oc)
    # an odd row count does not split in two: warned, then dense
    odd = lambda pb: PointBatch(*(x[:-1] for x in pb))
    s1o = s1._replace(corner_sharp=odd(s1.corner_sharp),
                      surf_flat=odd(s1.surf_flat))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fb = sharded_odometry.sharded_match_scan2scan(
            mesh_map, s0, s1o, Pose.identity("cpu"), oc)
    fb_dense = odometry.match_scan2scan(s0, s1o, Pose.identity("cpu"), oc)
    return dict(dp=_np(got), dp_dense=_np(pose),
                odo=_np(sharded), odo_dense=_np(dense),
                warned=[str(w.message) for w in rec],
                fb=_np(fb.pose_curr2last), fb_dense=_np(fb_dense.pose_curr2last))


def _case_solves(mesh_data):
    """The distributed solves and optimisers."""
    from msf_loam_tpu_torch.config import PoseGraphConfig
    from msf_loam_tpu_torch.ops import block_tridiag as bt
    from msf_loam_tpu_torch.parallel import distributed_ba as dba
    from msf_loam_tpu_torch.slam import posegraph as pg
    rng = np.random.default_rng(4)
    N, m = 40, 5
    D = rng.normal(size=(N, 6, 6))
    D = np.einsum("nij,nkj->nik", D, D) + 6 * np.eye(6)
    U = rng.normal(size=(N - 1, 6, 6)) * 0.3
    B = rng.normal(size=(N, 6, m))
    W = np.zeros((N, 6, 12))
    W[3, :, :6], W[31, :, :6] = rng.normal(size=(2, 6, 6)) * 0.5
    W[9, :, 6:], W[25, :, 6:] = rng.normal(size=(2, 6, 6)) * 0.5
    D, U, B, W = (torch.as_tensor(a.astype(np.float32)) for a in (D, U, B, W))
    poses0, data, loops = _pg_inputs()
    cfg = PoseGraphConfig()
    return dict(
        tri=_np(dba.distributed_tridiag_solve(mesh_data, D, U, B[..., 0])),
        tri_multi=_np(dba.distributed_tridiag_solve_multi(mesh_data, D, U,
                                                          B)),
        wood=_np(dba.distributed_woodbury_solve(mesh_data, D, U, B[..., 0],
                                                W)),
        tri_dense=_np(bt.block_tridiag(D, U, B)),
        wood_dense=_np(pg._woodbury_solve(D, U, B[..., 0], W)),
        opt=_np(pg.optimize_distributed(mesh_data, poses0, data, cfg,
                                        PG_ITERS).poses),
        opt_loops=_np(pg.optimize_with_loops_distributed(
            mesh_data, poses0, data, loops, cfg, PG_ITERS).poses))


def _case_checkpoint(mesh_map, scans, out_dir):
    """A world-2 save after 2 frames, resumed into a fresh pipeline,
    against the uninterrupted 4-frame run."""
    from msf_loam_tpu_torch.parallel.sharded_pipeline import \
        ShardedSlamPipeline
    from msf_loam_tpu_torch.slam import checkpoint
    cfg = _pipe_cfg(scans[0])
    scans = scans[1]
    full = ShardedSlamPipeline(cfg, mesh_map)
    for s in scans:
        full.process_scan(s)
    half = ShardedSlamPipeline(cfg, mesh_map)
    for s in scans[:2]:
        half.process_scan(s)
    path = os.path.join(out_dir, "ckpt.npz")
    checkpoint.save_sharded_checkpoint(half, path)
    resumed = ShardedSlamPipeline(cfg, mesh_map)
    checkpoint.load_sharded_checkpoint(resumed, path)
    resumed.prev_scan = scans[1]
    for s in scans[2:]:
        resumed.process_scan(s)
    # the JAX package's single-process file of a 2-way mesh (both slot
    # offsets in one file, written by the parent): each rank takes its own
    from msf_loam_tpu_torch.config import MappingConfig, MsfLoamConfig
    two = ShardedSlamPipeline(MsfLoamConfig(mapping=MappingConfig(
        **JAX_TWO_WAY)), mesh_map)
    checkpoint.load_sharded_checkpoint(two, os.path.join(out_dir, "jax2.npz"))
    return dict(full=full.trajectory(), resumed=resumed.trajectory(),
                files=sorted(f for f in os.listdir(out_dir)
                             if f.startswith("ckpt")),
                jax_two_way=_np(two.corner_map))


def _worker(rank: int, init: str, out_dir: str) -> None:
    """One rank of the gloo world of 2: every case, pickled to out_dir."""
    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    runtime.initialize(coordinator=init, num_processes=2, process_id=rank,
                       device="cpu", timeout_s=JOIN_S)
    mesh_map = mesh_mod.make_mesh(n_map=2, device="cpu")
    mesh_data = mesh_mod.make_mesh(n_map=1, n_data=2, device="cpu")
    try:
        mesh_mod.make_mesh(n_map=1, n_data=1, device="cpu")
        refused = False
    except ValueError:
        refused = True
    scans = _scans()
    res = dict(refused=refused, map=_case_map(mesh_map),
               gn=_case_gn(mesh_map, mesh_data, scans[1]),
               solves=_case_solves(mesh_data),
               ckpt=_case_checkpoint(mesh_map, scans, out_dir),
               collectives=dict(mesh_mod.COLLECTIVES))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    runtime.shutdown()


def _jax_optimisers():
    """JAX's optimize_distributed / optimize_with_loops_distributed on a
    2-way data mesh of the conftest's virtual devices, in one jit."""
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.config import PoseGraphConfig as JCfg
    from msf_loam_tpu.core.se3 import Pose as JPose
    from msf_loam_tpu.parallel import mesh as jmesh
    from msf_loam_tpu.slam import posegraph as jpg
    poses0, data, loops = _pg_inputs()
    P = lambda p: JPose(jnp.asarray(_np(p.t)), jnp.asarray(_np(p.q)))
    d = _np(data)
    jdata = jpg.PoseGraphData(
        times=d["times"], rel_meas=JPose(d["rel_meas"]["t"],
                                         d["rel_meas"]["q"]),
        rel_valid=d["rel_valid"], gps_xyz=d["gps_xyz"], gps_seg=d["gps_seg"],
        gps_frac=d["gps_frac"], gps_valid=d["gps_valid"])
    lo = _np(loops)
    jloops = jpg.LoopFactors(idx_i=lo["idx_i"], idx_j=lo["idx_j"],
                             meas=JPose(lo["meas"]["t"], lo["meas"]["q"]),
                             valid=lo["valid"])
    mesh = jmesh.make_mesh(n_map=1, n_data=2, devices=jax.devices()[:2])

    def run(p, dd, ll):
        a = jpg.optimize_distributed(mesh, p, dd, JCfg(), PG_ITERS)
        b = jpg.optimize_with_loops_distributed(mesh, p, dd, ll, JCfg(),
                                                PG_ITERS)
        return (a.poses.t, a.poses.q), (b.poses.t, b.poses.q)

    out = jax.jit(run)(P(poses0), jdata, jloops)
    return jax.tree.map(np.asarray, out)


JAX_TWO_WAY = dict(map_table_size=256, map_cell_capacity=8)


def _jax_two_way_file(path):
    """A JAX ShardedSlamPipeline on a 2-way map mesh of the conftest's
    virtual devices, its corner map set from seeded arrays, saved by one
    process (one file, both slot offsets). Returns the arrays."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from msf_loam_tpu.config import MappingConfig as JMappingConfig
    from msf_loam_tpu.config import MsfLoamConfig as JMsfLoamConfig
    from msf_loam_tpu.parallel import mesh as jmesh
    from msf_loam_tpu.parallel.sharded_pipeline import \
        ShardedSlamPipeline as JPipe
    from msf_loam_tpu.slam import checkpoint as jckpt
    H, P = JAX_TWO_WAY["map_table_size"], JAX_TWO_WAY["map_cell_capacity"]
    rng = np.random.default_rng(13)
    arrays = dict(points=rng.uniform(-9, 9, (H, P, 3)).astype(np.float32),
                  leaf_key=rng.integers(0, 1000, (H, P)).astype(np.int32),
                  count=rng.integers(0, P + 1, H).astype(np.int32),
                  n_obs=rng.uniform(size=(H, P)).astype(np.float32))
    mesh = jmesh.make_mesh(n_map=2, n_data=1, devices=jax.devices()[:2])
    pipe = JPipe(JMsfLoamConfig(mapping=JMappingConfig(**JAX_TWO_WAY)), mesh)
    shard = NamedSharding(mesh, PartitionSpec("map"))
    pipe.corner_map = pipe.corner_map._replace(**{
        k: jax.device_put(v, shard) for k, v in arrays.items()})
    jckpt.save_sharded_checkpoint(pipe, path)
    return arrays


def _checkpoint_crossing(tmp):
    """World 1 in this process: a port file into JAX's loader and a JAX
    file into the port's, field for field."""
    import jax
    import jax.numpy as jnp

    from msf_loam_tpu.config import MappingConfig as JMappingConfig
    from msf_loam_tpu.config import MsfLoamConfig as JMsfLoamConfig
    from msf_loam_tpu.parallel import mesh as jmesh
    from msf_loam_tpu.parallel.sharded_pipeline import \
        ShardedSlamPipeline as JPipe
    from msf_loam_tpu.slam import checkpoint as jckpt
    from msf_loam_tpu_torch.config import MappingConfig, MsfLoamConfig
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    from msf_loam_tpu_torch.parallel import sharded_map as sm
    from msf_loam_tpu_torch.parallel.sharded_pipeline import \
        ShardedSlamPipeline
    from msf_loam_tpu_torch.slam import checkpoint
    mcfg = dict(map_table_size=256, map_cell_capacity=8)
    runtime.initialize(device="cpu", timeout_s=JOIN_S)
    try:
        mesh = mesh_mod.make_mesh(n_map=1, device="cpu")
        pipe = ShardedSlamPipeline(MsfLoamConfig(
            mapping=MappingConfig(**mcfg)), mesh)
        rng = np.random.default_rng(9)
        pts = torch.as_tensor(rng.uniform(-9, 9, (800, 3)).astype(np.float32))
        ones = torch.ones(800, dtype=torch.bool)
        pipe.corner_map = sm.sharded_insert(mesh, pipe.corner_map, pts, ones)
        pipe.surf_map = sm.sharded_insert(mesh, pipe.surf_map, pts * 0.5,
                                          ones)
        pipe.pose_map = Pose(torch.tensor([1.0, 2.0, 3.0]),
                             torch.tensor([0.0, 1.0, 0.0, 0.0]))
        pipe.frame_idx = 7
        port_file = os.path.join(tmp, "port.npz")
        checkpoint.save_sharded_checkpoint(pipe, port_file)
        jmesh1 = jmesh.make_mesh(n_map=1, n_data=1,
                                 devices=jax.devices()[:1])
        jcfg = JMsfLoamConfig(mapping=JMappingConfig(**mcfg))
        jpipe = JPipe(jcfg, jmesh1)
        jckpt.load_sharded_checkpoint(jpipe, port_file)
        into_jax = dict(
            cmap={f: np.asarray(getattr(jpipe.corner_map, f))
                  for f in ("points", "leaf_key", "count", "n_obs")},
            frame_idx=jpipe.frame_idx, pose_map=np.asarray(jpipe.pose_map.t))
        # a JAX file: its map moved, back into a fresh port pipeline
        jpipe.surf_map = jpipe.surf_map._replace(
            count=jnp.asarray(np.asarray(jpipe.surf_map.count) // 2))
        jax_file = os.path.join(tmp, "jax.npz")
        jckpt.save_sharded_checkpoint(jpipe, jax_file)
        back = ShardedSlamPipeline(MsfLoamConfig(
            mapping=MappingConfig(**mcfg)), mesh)
        checkpoint.load_sharded_checkpoint(back, jax_file)
        return dict(port=_np(pipe.corner_map), into_jax=into_jax,
                    jax_surf_count=np.asarray(jpipe.surf_map.count),
                    back_surf=_np(back.surf_map), back_corner=_np(
                        back.corner_map), back_frame=back.frame_idx,
                    back_pose=_np(back.pose_map.t))
    finally:
        runtime.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' results, the JAX optimisers' and the world-1 checkpoint
    crossing (computed here while the children run)."""
    tmp = str(tmp_path_factory.mktemp("gloo2"))
    init = "file://" + os.path.join(tmp, "rendezvous")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, {!r}); import "
            "test_torch_parallel as t; t._worker({{}}, {!r}, {!r})").format(
                os.path.dirname(os.path.abspath(__file__)), init, tmp)
    two_way = _jax_two_way_file(os.path.join(tmp, "jax2.npz"))
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        jax_opt = _jax_optimisers()
        crossing = _checkpoint_crossing(str(tmp_path_factory.mktemp("w1")))
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
    return dict(ranks=ranks, jax_opt=jax_opt, crossing=crossing,
                two_way=two_way)


def interop_shard(whole, rank):
    from msf_loam_tpu_torch.interop import map_shard_from_numpy
    h = whole["count"].shape[0] // 2
    return map_shard_from_numpy(whole, rank * h, h, device="cpu")


def _equal_trees(a, b, path="") -> None:
    if isinstance(a, dict):
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def test_ranks_bit_equal_and_mesh_shapes(world):
    """Every result but each rank's own shard is bit-identical on both
    ranks; the mesh refuses a shape that is not the world; each
    collective was issued."""
    r0, r1 = world["ranks"]
    own = {("map", "local"), ("ckpt", "jax_two_way")}   # each rank's shard
    _equal_trees(*({k: ({kk: vv for kk, vv in v.items()
                         if (k, kk) not in own}
                        if isinstance(v, dict) else v)
                    for k, v in r.items()} for r in (r0, r1)))
    assert r0["refused"]
    assert r0["collectives"]["all_reduce"] > 0
    assert r0["collectives"]["all_gather"] > 0


def test_sharded_map_matches_dense(world):
    """The gathered shards equal the dense table (insert is owner-routed
    with local slots); the packed query pair and the single queries
    bit-equal on d2 to the dense queries, picks equal where valid; evict
    equals the dense evict."""
    from msf_loam_tpu_torch.interop import map_from_shards
    m = world["ranks"][0]["map"]
    _equal_trees(m["gathered"], m["dense"])
    # the shards, in the JAX package's layout by slot offset, and back
    whole = map_from_shards([r["map"]["local"] for r in world["ranks"]])
    for f in ("points", "leaf_key", "count", "n_obs"):
        np.testing.assert_array_equal(whole[f], m["dense"][f])
        np.testing.assert_array_equal(
            _np(interop_shard(whole, 1))[f], world["ranks"][1]["map"]
            ["local"][f])
    _equal_trees(m["evicted"], m["dense_evicted"])
    (c, s), (dc, ds) = m["pair"], m["dense_pair"]
    for got, want in ((c, dc), (s, ds), (m["single"], ds[:3]),
                      (m["single2"], ds)):
        for i in range(0, len(want), 3):
            d2, xyz, valid = got[i:i + 3]
            np.testing.assert_array_equal(d2, want[i])
            np.testing.assert_array_equal(valid, want[i + 2])
            np.testing.assert_array_equal(xyz[valid], want[i + 1][valid])
    assert m["points"] == int(m["dense"]["count"].sum())
    assert ds[2].any() and (~ds[2]).any()


def test_dp_gn_and_sharded_odometry(world):
    """DP-GN and the sharded scan-to-scan odometry within 1e-5 of their
    dense solves; rows that do not split warn and take the dense
    matcher."""
    g = world["ranks"][0]["gn"]
    for a, b in ((g["dp"], g["dp_dense"]),
                 (g["odo"]["pose_curr2last"], g["odo_dense"]["pose_curr2last"])):
        np.testing.assert_allclose(a["t"], b["t"], atol=1e-5)
        np.testing.assert_allclose(a["q"], b["q"], atol=1e-5)
    assert g["odo"]["n_correspondences"] == g["odo_dense"]["n_correspondences"]
    assert bool(g["odo"]["ok"])
    assert len(g["warned"]) == 1 and "dense matcher" in g["warned"][0]
    _equal_trees(g["fb"], g["fb_dense"])


def test_distributed_solves(world):
    """The condense / gathered separator / back-substitute solves within
    1e-5 of the one-launch solve, one RHS, several and Woodbury."""
    s = world["ranks"][0]["solves"]
    np.testing.assert_allclose(s["tri"], s["tri_dense"][..., 0], atol=1e-5)
    np.testing.assert_allclose(s["tri_multi"], s["tri_dense"], atol=1e-5)
    np.testing.assert_allclose(s["wood"], s["wood_dense"], atol=1e-5)


def test_distributed_posegraph_matches_jax(world):
    """optimize_distributed and optimize_with_loops_distributed at world 2
    within 1e-4 m / 1e-4 of the JAX package's on a 2-way data mesh."""
    s = world["ranks"][0]["solves"]
    (jt, jq), (lt, lq) = world["jax_opt"]
    np.testing.assert_allclose(s["opt"]["t"], jt, atol=1e-4)
    np.testing.assert_allclose(s["opt"]["q"], jq, atol=1e-4)
    np.testing.assert_allclose(s["opt_loops"]["t"], lt, atol=1e-4)
    np.testing.assert_allclose(s["opt_loops"]["q"], lq, atol=1e-4)


def test_sharded_checkpoint(world):
    """World 2: one file a rank, the resume within 1e-5 m of the
    uninterrupted run; the JAX package's one-file save of a 2-way mesh
    loads at world 2, each rank its own slots. World 1: a port file loads
    into the JAX pipeline and a JAX file into the port's, field for
    field."""
    ck = world["ranks"][0]["ckpt"]
    h = JAX_TWO_WAY["map_table_size"] // 2
    for r, rank in enumerate(world["ranks"]):
        for f, v in world["two_way"].items():
            np.testing.assert_array_equal(rank["ckpt"]["jax_two_way"][f],
                                          v[r * h:(r + 1) * h])
    assert ck["files"] == ["ckpt.npz.proc0", "ckpt.npz.proc1"]
    np.testing.assert_allclose(ck["resumed"][:, 1:4], ck["full"][:, 1:4],
                               atol=1e-5)
    x = world["crossing"]
    for f in ("points", "leaf_key", "count", "n_obs"):
        np.testing.assert_array_equal(x["into_jax"]["cmap"][f], x["port"][f])
        np.testing.assert_array_equal(x["back_corner"][f], x["port"][f])
    np.testing.assert_array_equal(x["back_surf"]["count"],
                                  x["jax_surf_count"])
    assert x["into_jax"]["frame_idx"] == 7 and x["back_frame"] == 7
    np.testing.assert_array_equal(x["into_jax"]["pose_map"], [1, 2, 3])
    np.testing.assert_array_equal(x["back_pose"], [1, 2, 3])
