"""The port's LIO path (``msf_loam_tpu_torch``: ``SlamPipeline.add_imu`` +
``process_ring_image``) against the JAX package's, on the distorted
corridor drive of tests/test_lio_pipeline.py at a small size (8 rings x
512 points, init_frames=3, warmup_msgs=10, tight coupling).

The JAX pipeline runs 5 frames once (a module fixture). Before each frame
its whole state (maps, poses, previous scan, IMU estimator with its
preintegrations, sample buffer) is carried into a fresh port pipeline by
``interop.load_pipeline_state``, so each frame is compared on its own:
frames 0-2 take the modular ``process_scan`` route (rotation-only deskew,
estimator warm-up, the gravity initialisation at frame 2), frames 3-4 the
fused LIO frame (``lio_frame_core``). The JAX side runs its kernel path
(fused_corr / fused_select "on", Pallas in interpret mode); the port runs
its kernels' plain versions on the CPU. Per frame: mapped pose within
1e-4 m / 1e-4, velocity within 1e-3 m/s, gravity within 1e-4 m/s^2 and
the initialisation flag equal (one frame of float32 Gauss-Newton whose
sums run in another order)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import FeatureConfig as JFeatureConfig
from msf_loam_tpu.config import ImuConfig as JImuConfig
from msf_loam_tpu.config import MappingConfig as JMappingConfig
from msf_loam_tpu.config import MsfLoamConfig as JMsfLoamConfig
from msf_loam_tpu.config import OdometryConfig as JOdometryConfig
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.dataio import preprocess as jpre
from msf_loam_tpu.dataio import synthetic as jsyn
from msf_loam_tpu.imu import deskew as jdeskew
from msf_loam_tpu.imu import imu_factor as jfactor
from msf_loam_tpu.ops import gauss_newton as jgn
from msf_loam_tpu.ops import icp_residuals as jicp
from msf_loam_tpu.slam import mapping as jmapping
from msf_loam_tpu.slam import voxel_map as jvm
from msf_loam_tpu.slam.pipeline import SlamPipeline as JSlamPipeline
from msf_loam_tpu.slam.pipeline import downsample_features as jdownsample
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import (FeatureConfig, ImuConfig, MappingConfig,
                                       MsfLoamConfig, OdometryConfig)
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.imu import deskew
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.ops import icp_residuals as icp
from msf_loam_tpu_torch.slam import mapping
from msf_loam_tpu_torch.slam import voxel_map as vm
from msf_loam_tpu_torch.slam.pipeline import SlamPipeline, downsample_features

torch.set_num_threads(1)

FEAT = dict(max_points_per_ring=512, max_less_flat=1024)
MAP = dict(map_table_size=1 << 12, max_query_points=256,
           max_corner_query_points=128, gather_groups=128)
# the "scan" lowering of the preintegration: XLA compiles JAX's "assoc"
# lowering in ~5 s per instance; both lowerings are held to JAX in
# tests/test_torch_imu.py
IMU = dict(init_frames=3, warmup_msgs=10, max_imu_samples=64,
           tight_coupling=True, preint_mode="scan")
# one odometry round (a smaller JAX compile): the LIO frame runs the
# lidar frame's odometry unchanged, and tests/test_torch_pipeline.py holds
# its two rounds to JAX; the scan-to-map matchers keep their two rounds
ODO = dict(outer_rounds=1)
G = np.array([0.0, 0.0, 9.81])
V0 = np.array([1.2, 0.4, 0.0])
YAW_RATE = 0.25
T0, N_FRAMES = 1.0, 5


def _pose_at(t):
    c, s = np.cos(YAW_RATE * t), np.sin(YAW_RATE * t)
    return V0 * t, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _np(tree):
    return jax.tree.map(np.array, tree)


def _snapshot(jp):
    """numpy copies of a JAX pipeline's state (its fused frames donate the
    maps, and its estimator mutates the state dicts)."""
    snap = copy.copy(jp)
    for name in ("corner_map", "surf_map", "pose_odom", "pose_curr2last",
                 "pose_odom2map", "pose_map", "prev_scan", "velocity",
                 "gravity", "bias_acc", "bias_gyr"):
        setattr(snap, name, _np(getattr(jp, name)))
    snap._states = [{k: _np(v) for k, v in st.items()} for st in jp._states]
    return snap


@pytest.fixture(scope="module")
def drive():
    """The JAX pipeline over the 5 frames: each frame's ring image, the
    state before it and the results after it."""
    jcfg = JMsfLoamConfig(features=JFeatureConfig(fused_picks="off", **FEAT),
                          odometry=JOdometryConfig(fused_corr="on", **ODO),
                          mapping=JMappingConfig(fused_select="on", **MAP),
                          imu=JImuConfig(**IMU))
    jp = JSlamPipeline(jcfg)
    t = T0 - 0.5
    while t < T0 + N_FRAMES * 0.1 + 0.2:
        _, R = _pose_at(t)
        jp.add_imu(t, R.T @ G, np.array([0.0, 0.0, YAW_RATE]))
        t += 1.0 / 400
    world = jsyn.World.corridor(seed=0, size=12.0)
    frames = []
    for i in range(N_FRAMES):
        ts = T0 + 0.1 * i
        p, R = _pose_at(ts)
        xyz, ring = jsyn.simulate_scan(world, p, R, n_rings=8,
                                       pts_per_ring=512, noise=0.004, seed=i,
                                       linear_vel=V0, yaw_rate=YAW_RATE)
        img = jpre.preprocess_scan(xyz, ring, jcfg.features, num_rings=8)
        before = _snapshot(jp)
        res = jp.process_ring_image(img, ts)
        frames.append(dict(ts=ts, img=_np(img), before=before,
                           map_pose=_np(res.map_pose),
                           velocity=np.array(jp.velocity),
                           gravity=np.array(jp.gravity),
                           init=jp.is_initialized))
    return jcfg, frames, jp


def _port_cfg():
    return MsfLoamConfig(features=FeatureConfig(**FEAT),
                         odometry=OdometryConfig(**ODO),
                         mapping=MappingConfig(**MAP), imu=ImuConfig(**IMU))


@pytest.mark.parametrize("i", range(N_FRAMES))
def test_lio_frame_matches_jax(drive, i):
    _, frames, _ = drive
    fr = frames[i]
    tp = SlamPipeline(_port_cfg(), device="cpu")
    interop.load_pipeline_state(tp, fr["before"])
    fused = tp.has_imu and tp.is_initialized and tp.prev_scan is not None
    assert fused == (i >= 3)                     # the route under test
    got = tp.process_ring_image(
        interop.ring_image_from_numpy(fr["img"], "cpu"), fr["ts"])
    np.testing.assert_allclose(got.map_pose.t.numpy(), fr["map_pose"].t,
                               atol=1e-4)
    np.testing.assert_allclose(got.map_pose.q.numpy(), fr["map_pose"].q,
                               atol=1e-4)
    np.testing.assert_allclose(tp.velocity.numpy(), fr["velocity"], atol=1e-3)
    np.testing.assert_allclose(tp.gravity.numpy(), fr["gravity"], atol=1e-4)
    assert tp.is_initialized == fr["init"] == (i >= 2)
    assert len(tp._states) == i + 1
    if i == N_FRAMES - 1:                         # the drive moved
        assert float(got.map_pose.t[0]) > 0.3


def _matcher_inputs(drive):
    """The state before frame 4: maps, frame 3's scan (downsampled), the
    IMU windows and the pre-solve prediction, on both sides."""
    jcfg, frames, jp = drive
    before = frames[4]["before"]
    mc = jcfg.mapping
    jscan = jax.tree.map(jnp.asarray, before.prev_scan)
    jc = jdownsample(jscan.corner_less_sharp, mc.line_resolution,
                     mc.corner_query_points)
    js = jdownsample(jscan.surf_less_flat, mc.plane_resolution,
                     mc.max_query_points)
    prev = before._states[-1]
    ts = frames[4]["ts"]
    ba, bg = jnp.asarray(before.bias_acc), jnp.asarray(before.bias_gyr)
    jpair = jp._preintegrate_window(prev["time"], ts)
    jscanpre = jp._preintegrate_window(ts, ts + 0.1)
    jstate = jfactor.ImuState(JPose(jnp.asarray(prev["p"]),
                                    jnp.asarray(prev["q"])),
                              jnp.asarray(prev["v"]), ba, bg)
    g = jnp.asarray(before.gravity)
    jpred = jfactor.imu_presolve(jpair, jstate, g)
    jin = dict(maps=(jax.tree.map(jnp.asarray, before.corner_map),
                     jax.tree.map(jnp.asarray, before.surf_map)),
               c=jc, s=js, pose=jpred.pose, v=jpred.v, g=g,
               cdk=jdeskew.deskew_terms(jscanpre, jc.rel_time, g),
               sdk=jdeskew.deskew_terms(jscanpre, js.rel_time, g),
               pair=jpair, state=jstate)
    tscan = interop.scan_features_from_numpy(before.prev_scan, "cpu")
    tc = downsample_features(tscan.corner_less_sharp, mc.line_resolution,
                             mc.corner_query_points)
    tsd = downsample_features(tscan.surf_less_flat, mc.plane_resolution,
                              mc.max_query_points)
    assert np.array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))
    assert np.array_equal(tsd.mask.numpy(), np.asarray(js.mask))
    tpair = interop.preintegration_from_numpy(_np(jpair), "cpu")
    tscanpre = interop.preintegration_from_numpy(_np(jscanpre), "cpu")
    tg = torch.from_numpy(np.array(g))
    tin = dict(maps=(interop.map_from_numpy(before.corner_map, "cpu"),
                     interop.map_from_numpy(before.surf_map, "cpu")),
               c=tc, s=tsd, pose=interop.pose_from_numpy(_np(jpred.pose), "cpu"),
               v=torch.from_numpy(np.array(jpred.v)), g=tg,
               cdk=deskew.deskew_terms(tscanpre, tc.rel_time, tg),
               sdk=deskew.deskew_terms(tscanpre, tsd.rel_time, tg),
               pair=tpair, state=interop.imu_state_from_numpy(_np(jstate), "cpu"))
    return jcfg, jin, tin


@pytest.mark.parametrize("tight", [False, True])
def test_scan2map_imu_matchers_match_jax(drive, tight):
    """match_scan2map_deskew_core (velocity held) and
    match_scan2map_tight_core (IMU factor in the solve, velocity free) on
    one captured state, through the one-level planar candidate gather, one
    re-association round (a third less JAX compile than two; the drive
    above runs two through the tight core): pose within 1e-4, velocity
    within 1e-3 m/s."""
    jcfg, j, t = _matcher_inputs(drive)
    mc = dataclasses.replace(jcfg.mapping, outer_rounds=1)
    tmc = dataclasses.replace(_port_cfg().mapping, outer_rounds=1)
    if tight:
        want = jmapping.match_scan2map_tight(
            *j["maps"], j["c"], j["s"], j["pose"], j["v"], j["g"], j["cdk"],
            j["sdk"], j["pair"], j["state"], mc, imu_weight=10.0)
        got = mapping.match_scan2map_tight_core(
            *t["maps"], t["c"], t["s"], t["pose"], t["v"], t["g"], t["cdk"],
            t["sdk"], t["pair"], t["state"], tmc, imu_weight=10.0)
    else:
        want = jmapping.match_scan2map_deskew(
            *j["maps"], j["c"], j["s"], j["pose"], j["v"], j["g"], j["cdk"],
            j["sdk"], mc)
        got = mapping.match_scan2map_deskew_core(
            *t["maps"], t["c"], t["s"], t["pose"], t["v"], t["g"], t["cdk"],
            t["sdk"], tmc)
    assert bool(got.ok) and bool(want.ok)
    np.testing.assert_allclose(got.pose.t.numpy(), want.pose.t, atol=1e-4)
    np.testing.assert_allclose(got.pose.q.numpy(), want.pose.q, atol=1e-4)
    np.testing.assert_allclose(got.velocity.numpy(), want.velocity, atol=1e-3)
    assert abs(float(got.n_plane) - float(want.n_plane)) <= 2
    if not tight:
        np.testing.assert_array_equal(got.velocity.numpy(), t["v"].numpy())


def test_gather_candidates_planar_bit_equal(drive):
    """The one-level (3, Q, 8P) octant gather of the pre-initialisation
    matcher, over the mapped surf map and world-frame queries."""
    _, frames, _ = drive
    before = frames[4]["before"]
    rng = np.random.default_rng(0)
    q = (np.asarray(before.prev_scan.surf_less_flat.xyz)[:200]
         + rng.normal(0, 0.5, (200, 3))).astype(np.float32)
    jmap = jax.tree.map(jnp.asarray, before.surf_map)
    want = jvm.gather_candidates_planar(jmap, jnp.asarray(q),
                                        jnp.ones(200, bool))
    got = vm.gather_candidates_planar(
        interop.map_from_numpy(before.surf_map, "cpu"), torch.from_numpy(q))
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < 1e9).any()


def test_deskew_residuals_and_nine_dim_gauss_newton():
    """edge/plane deskew residuals and their 9-dim Jacobians on seeded
    correspondences (1e-5 relative to the largest entry), and a 3-iteration
    9-dim Gauss-Newton over them with the velocity free (pose 1e-5,
    velocity 1e-4)."""
    rng = np.random.default_rng(3)
    n = 60
    pts = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    c = (pts + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    dq = rng.normal(0, 0.01, (n, 4))
    dq[:, 0] = 1.0
    dq = (dq / np.linalg.norm(dq, axis=1, keepdims=True)).astype(np.float32)
    dk = dict(delta_p=rng.normal(0, 0.02, (n, 3)).astype(np.float32),
              delta_q=dq, dt=rng.uniform(0, 0.1, n).astype(np.float32),
              gravity=G.astype(np.float32))
    jdk = jicp.DeskewTerms(**{k: jnp.asarray(v) for k, v in dk.items()})
    tdk = icp.DeskewTerms(**{k: torch.from_numpy(v) for k, v in dk.items()})
    q0 = np.array([0.999, 0.01, -0.02, 0.03], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = np.array([0.1, -0.05, 0.02], np.float32)
    v0 = np.array([1.0, 0.3, 0.0], np.float32)
    jpose, tpose = JPose(jnp.asarray(t0), jnp.asarray(q0)), \
        Pose(torch.from_numpy(t0), torch.from_numpy(q0))
    jargs = [jnp.asarray(a) for a in (pts, c, nrm, valid)]
    targs = [torch.from_numpy(a) for a in (pts, c, nrm, valid)]
    for jf, tf in ((jicp.edge_residuals_deskew, icp.edge_residuals_deskew),
                   (jicp.plane_residuals_deskew, icp.plane_residuals_deskew)):
        want = jf(jpose, jnp.asarray(v0), *jargs, jdk)
        got = tf(tpose, torch.from_numpy(v0), *targs, tdk)
        for a, b in ((got.r, want.r), (got.J, want.J)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()

    def jbuild(p, v):
        eb = jicp.edge_residuals_deskew(p, v, *jargs, jdk)
        pb = jicp.plane_residuals_deskew(p, v, *jargs, jdk)
        return [eb, pb], [jgn.huber_weights(eb, 0.1), jgn.huber_weights(pb, 0.1)]

    def tbuild(p, v):
        eb = icp.edge_residuals_deskew(p, v, *targs, tdk)
        pb = icp.plane_residuals_deskew(p, v, *targs, tdk)
        return [eb, pb], [gn.huber_weights(eb, 0.1), gn.huber_weights(pb, 0.1)]

    want = jgn.gauss_newton(jbuild, jpose, jnp.asarray(v0), n_iters=3,
                            state_dim=9)
    got = gn.gauss_newton(tbuild, tpose, torch.from_numpy(v0), n_iters=3,
                          state_dim=9)
    np.testing.assert_allclose(got.pose.t.numpy(), want.pose.t, atol=1e-5)
    np.testing.assert_allclose(got.pose.q.numpy(), want.pose.q, atol=1e-5)
    np.testing.assert_allclose(got.velocity.numpy(), want.velocity, atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4)
    # the rigid residuals padded to the 9-dim state keep zero columns
    pad = icp.edge_residuals(tpose, *targs, state_dim=9).J
    assert pad.shape[-1] == 9 and not pad[..., 6:].any()
