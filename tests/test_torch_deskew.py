"""The port's motion deskew, in-matcher deskew and three-point planes
against the JAX package.

``undistort_from_motion`` is held to JAX's eager and compiled calls (the
pre-initialisation LIO frame calls it eagerly, so s = rel_time / T is a
true division there; the compiled frames and matcher multiply by
float32(1 / T)), the three-point picks to JAX's argmins over its own
distance matrix, and ``match_scan2scan`` with ``deskew`` and
``plane_corr="triangle"`` to JAX's compiled matcher on its kernel path
(fused_corr "on": the edge odo_corr in Pallas interpret mode), the file's
one JAX compile. The accelerating-platform scene of
``tests/test_odometry.py`` runs on the port alone, with both plane
constructions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu import config as jconfig
from msf_loam_tpu.core.pointcloud import PointBatch as JPointBatch
from msf_loam_tpu.core.pointcloud import ScanFeatures as JScanFeatures
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.imu.deskew import undistort_from_motion as j_undistort
from msf_loam_tpu.slam import odometry as jodo
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                       MsfLoamConfig, OdometryConfig)
from msf_loam_tpu_torch.core.pointcloud import PointBatch
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.dataio import preprocess, synthetic
from msf_loam_tpu_torch.imu.deskew import undistort_from_motion
from msf_loam_tpu_torch.ops.features import extract_features
from msf_loam_tpu_torch.slam import odometry

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

WORLD = synthetic.World.corridor(seed=0, size=12.0)


def _to_jax(tree):
    """A port container (nested NamedTuples of tensors) as the JAX
    package's, field for field."""
    d = interop.to_numpy(tree)
    if isinstance(tree, PointBatch):
        return JPointBatch(*(jnp.asarray(d[f]) for f in JPointBatch._fields))
    if isinstance(tree, Pose):
        return JPose(jnp.asarray(d["t"]), jnp.asarray(d["q"]))
    return JScanFeatures(time=jnp.asarray(d["time"]), **{
        k: JPointBatch(*(jnp.asarray(d[k][f]) for f in JPointBatch._fields))
        for k in JScanFeatures._fields if k != "time"})


def _cloud_and_poses(B=2, N=1000, seed=0):
    """(B, N) seeded points with rel_time in [-0.01, 0.11] (both clamps
    reached) and B motion steps, lane 1's quaternion with w < 0 (slerp's
    shortest-arc flip)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    rel = rng.uniform(-0.01, 0.11, (B, N)).astype(np.float32)
    rel[:, :4] = [0.0, 0.1, -0.01, 0.11]
    axis = rng.normal(size=(B, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = np.array([0.05, 0.3])[:B]
    q = np.concatenate([np.cos(ang / 2)[:, None],
                        np.sin(ang / 2)[:, None] * axis], 1)
    q[1] *= -1.0
    pb = PointBatch(torch.from_numpy(xyz), torch.from_numpy(rel),
                    torch.zeros((B, N), dtype=torch.int32),
                    torch.ones((B, N), dtype=torch.bool))
    pose = Pose(torch.from_numpy(rng.normal(scale=0.3, size=(B, 3))
                                 .astype(np.float32)),
                torch.from_numpy(q.astype(np.float32)))
    return pb, pose


def test_undistort_from_motion_matches_jax_in_each_division_mode():
    """s = clip(rel_time / T, 0, 1) is bit-equal to JAX's in both rounding
    modes: a tensor T divides as JAX's eager call does, a Python float T
    multiplies by float32(1 / T) as XLA's compiled call does (the modes
    differ on many points, so the rule matters). With lanes, the eager
    translation-only deskew is bit-equal; the rotating deskew and the
    compiled calls differ from JAX by at most 2 ulp of the coordinates
    (JAX's jnp.cross contracts into multiply-adds, XLA fuses the compiled
    expression, and the slerp's sin / arccos are other implementations)."""
    pb, pose = _cloud_and_poses()
    jpb, jpose = _to_jax(pb), _to_jax(pose)
    T = 0.1

    def port(p, ps, eager, tr):
        dt = torch.tensor(T) if eager else T
        return undistort_from_motion(p, ps, dt, tr).xyz.numpy()

    def jax_call(p, ps, eager, tr):
        f = jax.vmap(lambda a, b: j_undistort(a, b, T, tr))
        return np.asarray((f if eager else jax.jit(f))(p, ps).xyz)

    # s alone: zero points moved by a unit x step
    unit = Pose(torch.tensor([[1.0, 0.0, 0.0]] * 2),
                torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2))
    zero = pb._replace(xyz=torch.zeros_like(pb.xyz))
    s = {}
    for eager in (True, False):
        got = port(zero, unit, eager, True)[..., 0]
        want = jax_call(_to_jax(zero), _to_jax(unit), eager, True)[..., 0]
        np.testing.assert_array_equal(got, want)
        s[eager] = got
    assert (s[True] != s[False]).mean() > 0.05
    assert s[True].min() == 0.0 and s[True].max() == 1.0

    scale = float(np.abs(pb.xyz.numpy()).max()) + 1.0
    ulp = float(np.spacing(np.float32(scale)))
    for tr in (True, False):
        for eager in (True, False):
            got = port(pb, pose, eager, tr)
            want = jax_call(jpb, jpose, eager, tr)
            if tr and eager:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * ulp)
    # the lanes are independent: lane 1 alone gives lane 1's rows
    one = undistort_from_motion(PointBatch(*(a[1] for a in pb)),
                                Pose(pose.t[1], pose.q[1]), T)
    assert torch.equal(one.xyz, undistort_from_motion(pb, pose, T).xyz[1])


def _scan(t, v, seed, fcfg, n_rings=16, pts=1800):
    xyz, ring = synthetic.simulate_scan(WORLD, np.asarray(t, float), np.eye(3),
                                        n_rings=n_rings, pts_per_ring=pts,
                                        noise=0.004, seed=seed,
                                        linear_vel=np.asarray(v, float),
                                        yaw_rate=0.0)
    img = preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=n_rings,
                                     device="cpu")
    return extract_features(img, torch.tensor(0.0), fcfg)


def test_three_point_picks_match_jax_outside_the_margin():
    """8 rings x 512 points: the port's a / b / c picks (dx²+dy²+dz²)
    equal JAX's argmins over its |q|²+|r|²−2q·r matrix wherever the
    float64 gap between a selection's best and runner-up exceeds 1e-6
    (|q|²+|r|²); centres and normals within 1e-5 of JAX's where both are
    valid. Engineered rows: an exact duplicate of a's point on a's ring is
    b (excluded by index, not distance), a masked query is an all-+inf
    row (index 0, not ok). Two lanes give each lane's single result."""
    fcfg = FeatureConfig(max_points_per_ring=512, max_less_flat=1024)
    cfg = OdometryConfig(plane_corr="triangle")
    s0 = _scan([0, 0, 0], [2.0, 0, 0], 1, fcfg, 8, 512)
    s1 = _scan([0.2, 0.05, 0], [2.0, 0, 0], 2, fcfg, 8, 512)
    ref, query = s0.surf_less_flat, s1.surf_flat
    # the last reference row becomes an exact duplicate of the first
    # valid one, on its ring; the first live query sits 1 cm from it
    r0, k = int(ref.mask.nonzero()[0]), ref.mask.shape[0] - 1
    ref = PointBatch(ref.xyz.clone(), ref.rel_time, ref.ring.clone(),
                     ref.mask.clone())
    ref.xyz[k], ref.ring[k], ref.mask[k] = ref.xyz[r0], ref.ring[r0], True
    pose = Pose(torch.tensor([0.2, 0.05, 0.0]),
                torch.tensor([1.0, 0.0, 0.0, 0.0]))
    query = PointBatch(query.xyz.clone(), query.rel_time, query.ring,
                       query.mask.clone())
    q_first = int(query.mask.nonzero()[0])
    query.xyz[q_first] = ref.xyz[r0] - pose.t + 0.01
    query.mask[-1] = False
    qw = pose.apply(query.xyz)
    a, a_ok, b, b_ok, c, c_ok = (x.numpy() for x in odometry.three_point_picks(
        qw, query.mask, ref, cfg))
    assert a[q_first] == r0 and b[q_first] == k and a_ok[q_first]
    assert a[-1] == b[-1] == c[-1] == 0 and not a_ok[-1]

    jref = _to_jax(ref)
    jd2 = np.asarray(jax.jit(jodo._corr_d2)(jnp.asarray(qw.numpy()),
                                            jnp.asarray(query.mask.numpy()),
                                            jref))
    ring = ref.ring.numpy()
    ja = jd2.argmin(1)
    same = (ring[None] == ring[ja][:, None]) & \
        (np.arange(len(ring))[None] != ja[:, None])
    dr = np.abs(ring[None] - ring[ja][:, None]).astype(np.float32)
    near = (dr > 0) & (dr <= cfg.nearby_scan)
    jb = np.where(same, jd2, np.inf).argmin(1)
    jc = np.where(near, jd2, np.inf).argmin(1)

    q64 = qw.numpy().astype(np.float64)
    r64 = ref.xyz.numpy().astype(np.float64)
    exact = ((q64[:, None] - r64[None]) ** 2).sum(-1)
    exact[~(query.mask.numpy()[:, None] & ref.mask.numpy()[None])] = np.inf
    tol = 1e-6 * ((q64 ** 2).sum(1)[:, None] + (r64 ** 2).sum(1)[None])

    def clear(sel):
        """Rows whose selection has a unique best beyond the margin."""
        d = np.where(sel, exact, np.inf)
        best = d.argmin(1)
        with np.errstate(invalid="ignore"):    # inf - inf: no candidate
            gap = np.partition(d, 1, axis=1)[:, 1] - d.min(1)
        return ~(gap <= tol[np.arange(len(d)), best])

    ok_a = clear(np.ones_like(exact, bool))
    ok_b = clear(same) & ok_a
    ok_c = clear(near) & ok_a
    live = query.mask.numpy()
    np.testing.assert_array_equal(a[ok_a & live], ja[ok_a & live])
    np.testing.assert_array_equal(b[ok_b & live], jb[ok_b & live])
    np.testing.assert_array_equal(c[ok_c & live], jc[ok_c & live])
    assert (ok_b & ok_c & live).sum() >= 0.9 * live.sum() > 50

    got = odometry.find_plane_correspondences(query, ref, pose, cfg)
    # lanes: (B,) poses and (B, N) clouds give each lane's own result
    lanes = odometry.find_plane_correspondences(
        PointBatch(*(torch.stack([a, a]) for a in query)),
        PointBatch(*(torch.stack([a, a]) for a in ref)),
        Pose(torch.stack([pose.t, 0 * pose.t]), torch.stack([pose.q] * 2)),
        cfg)
    alone = odometry.find_plane_correspondences(
        query, ref, Pose(0 * pose.t, pose.q), cfg)
    for g, a, b in zip(lanes, got, alone):
        assert torch.equal(g[0], a) and torch.equal(g[1], b)
    want = jodo.find_plane_correspondences(
        _to_jax(query), jref, _to_jax(pose),
        jconfig.OdometryConfig(plane_corr="triangle"))
    both = got.valid.numpy() & np.asarray(want.valid) & ok_b & ok_c
    assert both.sum() > 50
    np.testing.assert_array_equal(got.valid.numpy()[ok_b & ok_c],
                                  np.asarray(want.valid)[ok_b & ok_c])
    for g, w in ((got.plane_c, want.plane_c), (got.plane_n, want.plane_n)):
        np.testing.assert_allclose(g.numpy()[both], np.asarray(w)[both],
                                   rtol=0, atol=1e-5)


def test_deskew_triangle_matcher_matches_jax():
    """``match_scan2scan`` with ``deskew=True, plane_corr="triangle"`` on
    two distorted 16-ring scans of an accelerating platform: the port on
    the CPU within 1e-4 m / 1e-4 of JAX's compiled matcher, the same
    correspondence count within 2."""
    fcfg = FeatureConfig(max_points_per_ring=1024, max_less_flat=2048)
    v0, v1 = np.array([3.0, 0, 0]), np.array([4.0, 0, 0])
    step = (v0 + v1) / 2 * 0.1
    f0 = _scan(np.zeros(3), v0, 1, fcfg, 16, 900)
    f1 = _scan(step, v1, 2, fcfg, 16, 900)
    warm = Pose(torch.tensor(v0 * 0.1, dtype=torch.float32),
                torch.tensor([1.0, 0.0, 0.0, 0.0]))
    cfg = OdometryConfig(deskew=True, plane_corr="triangle")
    got = odometry.match_scan2scan(f0, f1, warm, cfg)
    want = jodo.match_scan2scan(
        _to_jax(f0), _to_jax(f1), _to_jax(warm),
        jconfig.OdometryConfig(deskew=True, plane_corr="triangle",
                               fused_corr="on"))
    np.testing.assert_allclose(got.pose_curr2last.t.numpy(),
                               np.asarray(want.pose_curr2last.t), atol=1e-4)
    np.testing.assert_allclose(got.pose_curr2last.q.numpy(),
                               np.asarray(want.pose_curr2last.q), atol=1e-4)
    assert abs(float(got.n_correspondences)
               - float(want.n_correspondences)) <= 2
    assert bool(got.ok) and bool(want.ok)
    assert np.linalg.norm(got.pose_curr2last.t.numpy() - step) < 0.05


@pytest.mark.parametrize("plane_corr", ["fit", "triangle"])
def test_deskew_recovers_true_step_on_accelerating_motion(plane_corr):
    """``tests/test_odometry.py``'s accelerating scene (16 x 1800 points,
    3 -> 4 m/s between scans) on the port: the in-matcher deskew recovers
    the scan-start-to-scan-start step within 0.02 m and under 0.6 x the
    rigid matcher's error, with either plane construction."""
    fcfg = FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    v0, v1 = np.array([3.0, 0, 0]), np.array([4.0, 0, 0])
    step = (v0 + v1) / 2 * 0.1
    f0 = _scan(np.zeros(3), v0, 1, fcfg)
    f1 = _scan(step, v1, 2, fcfg)
    warm = Pose(torch.tensor(v0 * 0.1, dtype=torch.float32),
                torch.tensor([1.0, 0.0, 0.0, 0.0]))
    rigid_cfg = OdometryConfig(plane_corr=plane_corr)
    rigid = odometry.match_scan2scan(f0, f1, warm, rigid_cfg)
    dsk = odometry.match_scan2scan(
        f0, f1, warm, dataclasses.replace(rigid_cfg, deskew=True))
    err_rigid = np.linalg.norm(rigid.pose_curr2last.t.numpy() - step)
    err_dsk = np.linalg.norm(dsk.pose_curr2last.t.numpy() - step)
    assert bool(dsk.ok)
    assert err_dsk < 0.02, (err_dsk, err_rigid)
    assert err_dsk < 0.6 * err_rigid, (err_dsk, err_rigid)


def test_config_accepts_the_switches_and_checks_the_scan_period():
    """The three switches construct, as in JAX; an in-matcher deskew whose
    scan period disagrees with the features' raises in both packages;
    ``mapping.reuse_candidates=False`` (the per-round association)
    constructs in both."""
    for od in (dict(motion_deskew=True), dict(deskew=True),
               dict(plane_corr="triangle"), dict(plane_corr="anything")):
        MsfLoamConfig(odometry=OdometryConfig(**od))
        jconfig.MsfLoamConfig(odometry=jconfig.OdometryConfig(**od))
    bad = dict(deskew=True, scan_period=0.05)
    with pytest.raises(ValueError, match="scan_period"):
        MsfLoamConfig(odometry=OdometryConfig(**bad))
    with pytest.raises(ValueError, match="scan_period"):
        jconfig.MsfLoamConfig(odometry=jconfig.OdometryConfig(**bad))
    # without deskew the mismatch is harmless in both
    MsfLoamConfig(odometry=OdometryConfig(scan_period=0.05))
    jconfig.MsfLoamConfig(odometry=jconfig.OdometryConfig(scan_period=0.05))
    MsfLoamConfig(mapping=MappingConfig(reuse_candidates=False))
    jconfig.MsfLoamConfig(mapping=jconfig.MappingConfig(
        reuse_candidates=False))
