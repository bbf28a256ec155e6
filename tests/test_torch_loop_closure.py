"""The port's loop closure and scan context (``msf_loam_tpu_torch.slam.
loop_closure`` / ``scan_context``) against the JAX package's on the same
numpy inputs, plus the JAX loop-closure tests' scenarios on the port alone
at their own bounds. No JAX pose-graph compile here: detection on the JAX
side is numpy and eager operations (and the one small jitted
``pairwise_min_distances``)."""

import numpy as np
import pytest
import torch

from msf_loam_tpu.slam import loop_closure as jlc
from msf_loam_tpu.slam import scan_context as jsc
from msf_loam_tpu_torch.config import FeatureConfig, MsfLoamConfig
from msf_loam_tpu_torch.config import PoseGraphConfig
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.dataio import preprocess, synthetic
from msf_loam_tpu_torch.ops.features import extract_features
from msf_loam_tpu_torch.slam import loop_closure as lc
from msf_loam_tpu_torch.slam import posegraph
from msf_loam_tpu_torch.slam import scan_context as sc

torch.set_num_threads(1)
CFG = PoseGraphConfig()
WORLD = synthetic.World.corridor(seed=0, size=14.0)


def tp(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _scan(p, yaw, seed):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    xyz, _ = synthetic.simulate_scan(WORLD, np.asarray(p, np.float64), R,
                                     n_rings=16, pts_per_ring=1800,
                                     noise=0.004, seed=seed)
    return xyz.astype(np.float32)


def _desc(xyz):
    return sc.compute_descriptor(torch.from_numpy(xyz),
                                 torch.ones(len(xyz), dtype=torch.bool))


@pytest.fixture(scope="module")
def drift_scans():
    """tests/test_scan_context.py's drift scenario: frames 0..10 march down
    the corridor, frame 11 revisits frame 0's place turned by 90 degrees."""
    n = 12
    return [_scan([0.6 * i, 0.0, 0.0], 0.0, i) if i < n - 1
            else _scan([0.0, 0.0, 0.0], np.pi / 2, 100) for i in range(n)]


# ------------------------------------------------------------ against JAX
def _near_edge(xyz, R=16, S=60, max_radius=20.0, tol=1e-4):
    """Points whose ring or sector coordinate lies within ``tol`` of a bin
    edge (float64), where an ulp of sqrt or atan2 can move them."""
    r = np.hypot(xyz[:, 0].astype(np.float64), xyz[:, 1])
    th = np.arctan2(xyz[:, 1].astype(np.float64), xyz[:, 0])
    ring = r / max_radius * R
    sec = (th + np.pi) / (2 * np.pi) * S
    edge = lambda x: np.abs(x - np.round(x)) < tol
    return edge(ring) | edge(sec), np.clip(ring.astype(int), 0, R - 1), \
        np.clip(sec.astype(int), 0, S - 1)


def _check_descriptors(drift_scans):
    """Max-height images equal bin for bin; a bin may differ only where one
    of its points sits within 1e-4 of a bin edge (sqrt / atan2 ulps)."""
    import jax.numpy as jnp
    for xyz in (drift_scans[5], drift_scans[-1]):
        mask = np.ones(len(xyz), bool)
        mask[::7] = False
        want = np.asarray(jsc.compute_descriptor(jnp.asarray(xyz),
                                                 jnp.asarray(mask)))
        got = sc.compute_descriptor(torch.from_numpy(xyz),
                                    torch.from_numpy(mask)).numpy()
        diff = np.argwhere(got != want)
        if len(diff):
            edge, ring, sec = _near_edge(xyz)
            for r, s in diff:
                assert (edge & mask & (ring == r) & (sec == s)).any(), (r, s)
        assert len(diff) <= 2


def _check_pairwise_and_detection(drift_scans):
    """All-pairs shifted distances (JAX's jitted matmul against torch's:
    summation orders differ, 1e-5) with equal best shifts, and equal
    detection triples (the prescreen: test_prescreen_ring_key_ties)."""
    import jax.numpy as jnp
    descs = np.stack([_desc(x).numpy() for x in drift_scans])
    dj, sj = (np.asarray(a) for a in
              jsc.pairwise_min_distances(jnp.asarray(descs)))
    dt, st = sc.pairwise_min_distances(torch.from_numpy(descs))
    np.testing.assert_allclose(dt.numpy(), dj, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(st.numpy(), sj)
    kw = dict(min_index_gap=8, max_dist=0.2, max_loops=2)
    want = jsc.detect_loops_scan_context(descs, **kw)
    assert want
    assert sc.detect_loops_scan_context(descs, device="cpu", **kw) == want


def _tie_descs(rng):
    """Synthetic descriptors with exact ring-key ties among the admissible
    candidates of query 0: descriptor 20 has descriptor 0's ring occupancy
    with its columns scrambled within each ring (same ring key, a
    different place), 21 is descriptor 0 rolled by 7 sectors (a revisit,
    same ring key), 22-24 are rolled copies of 20."""
    R, S, n = 16, 60, 26
    occ = rng.random((n, R, S)) < rng.uniform(0.2, 0.8, (n, R, 1))
    descs = (occ * rng.uniform(0.5, 3.0, (n, R, S))).astype(np.float32)
    descs[20] = np.stack([rng.permutation(row) for row in descs[0]])
    descs[21] = np.roll(descs[0], 7, axis=1)
    for j in (22, 23, 24):
        descs[j] = np.roll(descs[20], 3 * j, axis=1)
    return descs


def _check_prescreen_ties(prescreen):
    """Exact L1 ring-key ties: JAX's top_k takes the lower index first, the
    port's stable sort must pick the same candidates, so the triples are
    equal (with budget 1, both must miss the revisit at 21 behind the tied
    decoy at 20)."""
    descs = _tie_descs(np.random.default_rng(7))
    keys = sc.ring_key(torch.from_numpy(descs)).numpy()
    assert (keys[20] == keys[0]).all() and (keys[21] == keys[0]).all()
    kw = dict(min_index_gap=15, max_dist=0.2, max_loops=4,
              prescreen=prescreen)
    want = jsc.detect_loops_scan_context(descs, **kw)
    got = sc.detect_loops_scan_context(descs, device="cpu", **kw)
    assert got == want
    assert any(i == 0 and j == 21 for i, j, _ in want) == (prescreen > 1)


def test_detect_loops_matches_jax():
    """Proximity detection (numpy in both): out-and-back, straight, and a
    seeded random walk with several revisits and suppression."""
    fwd = np.linspace(0, 20, 30)
    pos = np.zeros((60, 3))
    pos[:30, 0] = fwd
    pos[30:, 0] = fwd[::-1]
    straight = np.zeros((60, 3))
    straight[:, 0] = np.linspace(0, 60, 60)
    walk = np.cumsum(np.random.default_rng(4).normal(size=(80, 3)) * 0.7, 0)
    for p, kw in ((pos, dict(max_dist=1.0, min_index_gap=20, max_loops=4)),
                  (straight, dict(max_dist=1.0, min_index_gap=20)),
                  (walk, dict(max_dist=2.0, min_index_gap=10, max_loops=6,
                              suppress_gap=5))):
        want = jlc.detect_loops(p, **kw)
        assert lc.detect_loops(p, **kw) == want
    assert jlc.detect_loops(pos, max_dist=1.0, min_index_gap=20)
    assert lc.detect_loops(straight, max_dist=1.0, min_index_gap=20) == []


# ------------------------------------------- the JAX scenarios, port alone
def test_descriptor_yaw_invariant_and_recovers_yaw():
    yaw_true = np.deg2rad(48.0)
    d0 = _desc(_scan([0, 0, 0], 0.0, 0))
    dy = _desc(_scan([0, 0, 0], yaw_true, 2))
    dist, _ = sc.shifted_distances(d0, dy[None])
    assert float(dist[0]) < 0.05
    loops = sc.detect_loops_scan_context(torch.stack([d0, dy]).numpy(),
                                         min_index_gap=1, max_dist=0.2,
                                         device="cpu")
    assert loops and loops[0][:2] == (0, 1)
    assert abs(loops[0][2] - yaw_true) < np.deg2rad(9.0)


def _drift_loop_problem(N=40, drift=0.02):
    """tests/test_loop_closure.py's square with a compounding yaw bias in
    the odometry (port Poses on the CPU)."""
    side = N // 4
    yaw = np.array([(i // side) * (np.pi / 2) for i in range(N)])
    gt_t = np.concatenate([np.zeros((1, 3)), np.cumsum(np.stack(
        [np.cos(yaw[1:]), np.sin(yaw[1:]), 0 * yaw[1:]], 1), 0)])
    yq = lambda y: np.stack([np.cos(y / 2), 0 * y, 0 * y, np.sin(y / 2)], -1)
    gt = Pose(tp(gt_t), tp(yq(yaw)))
    rel = Pose(gt.t[:-1], gt.q[:-1]).inverse().compose(
        Pose(gt.t[1:], gt.q[1:]))
    rel = Pose(rel.t, Pose(torch.zeros(N - 1, 3), rel.q).compose(
        Pose(torch.zeros(N - 1, 3), tp(yq(np.full(N - 1, drift))))).q)
    poses = [Pose(gt.t[0], gt.q[0])]
    for i in range(N - 1):
        poses.append(poses[-1].compose(Pose(rel.t[i], rel.q[i])))
    poses0 = Pose(torch.stack([p.t for p in poses]),
                  torch.stack([p.q for p in poses]))
    data = posegraph.PoseGraphData(
        times=torch.arange(N, dtype=torch.float32), rel_meas=rel,
        rel_valid=torch.ones(N - 1, dtype=torch.bool),
        gps_xyz=torch.zeros(1, 3), gps_seg=torch.zeros(1, dtype=torch.int64),
        gps_frac=torch.zeros(1), gps_valid=torch.zeros(1, dtype=torch.bool))
    return gt, poses0, data


def _loop_meas(gt, i, j):
    return Pose(gt.t[i], gt.q[i]).inverse().compose(Pose(gt.t[j], gt.q[j]))


def _check_loop_factor_drift():
    gt, poses0, data = _drift_loop_problem()
    N = gt.t.shape[0]
    m = _loop_meas(gt, 0, N - 1)
    loops = posegraph.LoopFactors.pad(np.array([0]), np.array([N - 1]),
                                      Pose(m.t[None], m.q[None]), to_l=4)
    data = data._replace(gps_xyz=gt.t[:1],
                         gps_valid=torch.ones(1, dtype=torch.bool))
    drift0 = float((poses0.t[-1] - gt.t[-1]).norm())
    out = posegraph.optimize_with_loops(poses0, data, loops, CFG, n_iters=15)
    drift1 = float((out.poses.t[-1] - gt.t[-1]).norm())
    assert drift0 > 0.5, f"problem not drifting: {drift0}"
    assert drift1 < 0.15 * drift0, f"loop closure failed: {drift0} -> {drift1}"
    assert float(out.final_cost) < float(out.initial_cost)


def _check_sparse_pose_graph():
    gt, poses0, data = _drift_loop_problem()
    N = gt.t.shape[0]
    m = _loop_meas(gt, 0, N - 1)
    g = lc.SparsePoseGraph()
    g.add_edge(lc.LoopEdge(0, N - 1, m.t.numpy(), m.q.numpy()))
    data = data._replace(gps_xyz=gt.t[:1],
                         gps_valid=torch.ones(1, dtype=torch.bool))
    drift0 = float((poses0.t[-1] - gt.t[-1]).norm())
    out = g.optimize(poses0, data, CFG, n_iters=15)
    assert float((out.poses.t[-1] - gt.t[-1]).norm()) < 0.15 * drift0


def _check_invalid_loops():
    """All-padded loop factors are inert: the chain-only optimizer's
    result within 1e-4."""
    gt, poses0, data = _drift_loop_problem(N=16)
    empty = Pose(torch.zeros(0, 3), torch.zeros(0, 4))
    loops = posegraph.LoopFactors.pad(np.zeros(0), np.zeros(0), empty, to_l=3)
    out_l = posegraph.optimize_with_loops(poses0, data, loops, CFG, n_iters=5)
    out_p = posegraph.optimize(poses0, data, CFG, n_iters=5)
    np.testing.assert_allclose(out_l.poses.t.numpy(), out_p.poses.t.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out_l.poses.q.numpy(), out_p.poses.q.numpy(),
                               atol=1e-4)


def test_match_loop_pair_submap_recovers_relative_pose():
    """Keyframe j registered against i's neighbourhood submap (4096 x 16
    slots) recovers a known relative pose within 0.03 m."""
    fcfg = FeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    cfg = MsfLoamConfig(features=fcfg)
    world = synthetic.World.corridor(seed=1, size=14.0)

    def feats_at(p, seed):
        xyz, ring = synthetic.simulate_scan(world, np.asarray(p, np.float64),
                                            np.eye(3), n_rings=16,
                                            pts_per_ring=1200, noise=0.004,
                                            seed=seed)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16, device="cpu")
        return extract_features(img, torch.tensor(0.0), fcfg)

    rel_true = np.array([0.4, 0.15, 0.0])
    neighbors = [(feats_at([0, 0, 0], 0), Pose.identity()),
                 (feats_at([0.3, 0, 0], 1),
                  Pose(tp([0.3, 0, 0]), tp([1.0, 0, 0, 0])))]
    guess = Pose(tp(rel_true + np.array([0.15, -0.1, 0])),
                 tp([1.0, 0, 0, 0]))
    rel, ok = lc.match_loop_pair_submap(neighbors, feats_at(rel_true, 2),
                                        guess, cfg)
    assert bool(ok)
    np.testing.assert_allclose(rel.t.numpy(), rel_true, atol=0.03)


# ------------------------------------------------------------------ tests
# Six tests a file: pytest-xdist's loadscope scheduling queues files by
# their test count, so a file of at most six tests queues behind
# test_nsh_bag.py (six tests, the suite's longest file) and never delays it.
def test_scan_context_matches_jax(drift_scans):
    _check_descriptors(drift_scans)
    _check_pairwise_and_detection(drift_scans)


def test_prescreen_ring_key_ties_match_jax():
    for prescreen in (1, 2):
        _check_prescreen_ties(prescreen)


def test_loop_factors_fix_drift():
    _check_loop_factor_drift()
    _check_sparse_pose_graph()
    _check_invalid_loops()
