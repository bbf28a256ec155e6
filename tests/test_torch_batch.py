"""The port's batched multi-sequence pipeline (slam/batch_pipeline.py)
against the JAX package.

A module fixture compiles the JAX ``batch_pipeline._frame_fn`` once (two
lanes with different worlds and trajectories, 8 rings x 512 points,
per-lane tables of 1 << 11 slots, eviction every second frame) and runs it
for three frames; before each frame the port starts from the JAX state
(``interop.batch_state_from_numpy``) and runs its own ``_frame_fn`` on the
CPU (the kernels' plain versions). The JAX side runs its kernel path
(fused_corr / fused_select "on", Pallas in interpret mode; XLA pick
rounds, bit-equal to its Pallas kernel). The other tests need no JAX
compile of a frame: the batched extraction, the lane axis of odo_corr and
the fused map operations are held to their per-lane counterparts and to
the JAX functions on seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import FeatureConfig as JFeatureConfig
from msf_loam_tpu.config import MappingConfig as JMappingConfig
from msf_loam_tpu.config import MsfLoamConfig as JMsfLoamConfig
from msf_loam_tpu.config import OdometryConfig as JOdometryConfig
from msf_loam_tpu.core.pointcloud import PointBatch as JPointBatch
from msf_loam_tpu.core.pointcloud import RingImage as JRingImage
from msf_loam_tpu.core.pointcloud import ScanFeatures as JScanFeatures
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.dataio import preprocess as jpre
from msf_loam_tpu.dataio import synthetic as jsyn
from msf_loam_tpu.slam import batch_pipeline as jbp
from msf_loam_tpu.slam import voxel_map as jvm
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                       MsfLoamConfig, OdometryConfig)
from msf_loam_tpu_torch.core.pointcloud import RingImage
from msf_loam_tpu_torch.ops import features as tfeat
from msf_loam_tpu_torch.ops import odo_corr as toc
from msf_loam_tpu_torch.slam import batch_pipeline as tbp
from msf_loam_tpu_torch.slam import voxel_map as tvm
from msf_loam_tpu_torch.slam.pipeline import SlamPipeline

FEAT = dict(max_points_per_ring=512, max_less_flat=1024)
MAP = dict(map_table_size=1 << 11, max_query_points=256,
           max_corner_query_points=128, gather_groups=128,
           map_evict_period=2, map_evict_radius=12.0)
B, T = 2, 3
CLOUDS = ("corner_sharp", "corner_less_sharp", "surf_flat", "surf_less_flat")

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def _images(fcfg, n_rings, pts, T, B):
    """(T, B) ring images as numpy: lane b drives its own world along its
    own arc."""
    out = []
    for t in range(T):
        lanes = []
        for b in range(B):
            yaw = (0.02 + 0.02 * b) * t
            R = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                          [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
            xyz, ring = jsyn.simulate_scan(
                jsyn.World.corridor(seed=b, size=12.0),
                np.array([0.2 * t, (0.03 + 0.02 * b) * t, 0.0]), R,
                n_rings=n_rings, pts_per_ring=pts, noise=0.004,
                seed=10 * b + t)
            lanes.append(jpre.preprocess_scan(xyz, ring, fcfg,
                                              num_rings=n_rings))
        out.append(lanes)
    return JRingImage(*(np.stack([np.stack([np.asarray(getattr(im, f))
                                            for im in lanes])
                                  for lanes in out])
                        for f in JRingImage._fields))


def _copy(tree):
    return jax.tree.map(np.array, tree)


def _jax_state(jcfg, cfg, B, n_rings):
    """The JAX BatchState ``init_batch_state`` builds, with the empty
    features and identity poses taken from the port's own initial state
    (the JAX init extracts them eagerly, which costs seconds)."""
    st = interop.to_numpy(tbp.init_batch_state(cfg, B, n_rings,
                                               device="cpu"))
    mc = jcfg.mapping
    pose = lambda d: JPose(jnp.asarray(d["t"]), jnp.asarray(d["q"]))
    pf = st["prev_feats"]
    return jbp.BatchState(
        corner_map=jvm.create_map(B * mc.map_table_size, mc.map_cell_capacity,
                                  mc.map_cell_size, mc.line_resolution),
        surf_map=jvm.create_map(B * mc.map_table_size, mc.map_cell_capacity,
                                mc.map_cell_size, mc.plane_resolution),
        prev_feats=JScanFeatures(jnp.asarray(pf["time"]), *(
            JPointBatch(**{k: jnp.asarray(v) for k, v in pf[c].items()})
            for c in JScanFeatures._fields[1:])),
        pose_c2l=pose(st["pose_c2l"]), pose_odom=pose(st["pose_odom"]),
        pose_o2m=pose(st["pose_o2m"]), frame_idx=jnp.int32(0))


@pytest.fixture(scope="module")
def drive():
    """Three frames of both frames, the port started from JAX's state
    before each one: per frame (JAX state before, JAX state after, JAX
    mapped poses, port state after, port mapped poses)."""
    # one odometry round: the frame's XLA:CPU compile takes ~40 s on one
    # core with two
    jcfg = JMsfLoamConfig(features=JFeatureConfig(fused_picks="off", **FEAT),
                          odometry=JOdometryConfig(fused_corr="on",
                                                   outer_rounds=1),
                          mapping=JMappingConfig(fused_select="on", **MAP))
    cfg = MsfLoamConfig(features=FeatureConfig(**FEAT),
                        odometry=OdometryConfig(outer_rounds=1),
                        mapping=MappingConfig(**MAP))
    H = MAP["map_table_size"]
    frame = jax.jit(lambda st, im, first: jbp._frame_fn(jcfg, H, st, im,
                                                        first))
    imgs = _images(jcfg.features, 8, 512, T, B)
    jstate = _jax_state(jcfg, cfg, B, 8)
    out = []
    for t in range(T):
        before = _copy(jstate)
        tstate = interop.batch_state_from_numpy(before, "cpu")
        img = JRingImage(*(a[t] for a in imgs))
        tnew, tpose = tbp._frame_fn(cfg, H, tstate,
                                    interop.ring_image_from_numpy(img, "cpu"),
                                    t == 0)
        jstate, jpose = frame(jstate, img, jnp.asarray(t == 0))
        out.append((before, _copy(jstate), _copy(jpose), tnew, tpose))
    return imgs, out


@pytest.mark.parametrize("t", range(T))
def test_frame_matches_jax_frame_by_frame(drive, t):
    """Per lane: mapped pose and scan-to-scan pose within 1e-4 (one frame
    of float32 Gauss-Newton whose sums run in another order), map counts
    within 0.5% + 1 (a point changes leaf voxel only at a boundary)."""
    _, frames = drive
    _, jst, jpose, tst, tpose = frames[t]
    for got, want in ((tpose, jpose), (tst.pose_c2l, jst.pose_c2l),
                      (tst.pose_odom, jst.pose_odom)):
        np.testing.assert_allclose(got.t.numpy(), want.t, atol=1e-4)
        np.testing.assert_allclose(got.q.numpy(), want.q, atol=1e-4)
    for tm, jm in ((tst.corner_map, jst.corner_map),
                   (tst.surf_map, jst.surf_map)):
        H = MAP["map_table_size"]
        for b in range(B):
            nt = int(tm.count[b * H:(b + 1) * H].sum())
            nj = int(jm.count[b * H:(b + 1) * H].sum())
            assert abs(nt - nj) <= 0.005 * nj + 1, (t, b, nt, nj)
    assert tst.frame_idx == int(jst.frame_idx) == t + 1
    if t == T - 1:      # the lanes moved apart, and eviction ran at frame 1
        assert float(tpose.t[1, 1]) > float(tpose.t[0, 1]) + 0.02
        assert int(tst.surf_map.count.sum()) > 200


def test_batched_extraction_bit_equal_to_lanes_and_to_jax_vmap(drive):
    """The port's batched extraction (lanes flattened into rings) equals
    its per-lane ``extract_features`` bit for bit, and the JAX frame's
    ``jax.vmap(extract_features)`` (its next state's previous features)
    leaf for leaf."""
    imgs, frames = drive
    cfg = FeatureConfig(**FEAT)
    for t in (0, 2):
        img = interop.ring_image_from_numpy(
            JRingImage(*(a[t] for a in imgs)), "cpu")
        got = tfeat.extract_features_batched(img, torch.zeros(B), cfg)
        want_jax = frames[t][1].prev_feats
        for b in range(B):
            lane = tfeat.extract_features(RingImage(*(a[b] for a in img)),
                                          torch.tensor(0.0), cfg)
            for name in CLOUDS + ("full",):
                g, w = getattr(got, name), getattr(lane, name)
                for f in w._fields:
                    assert torch.equal(getattr(g, f)[b], getattr(w, f)), \
                        (t, b, name, f)
        for name in CLOUDS:
            g, w = getattr(got, name), getattr(want_jax, name)
            for f in w._fields:
                np.testing.assert_array_equal(getattr(g, f).numpy(),
                                              getattr(w, f),
                                              err_msg=f"{t} {name}.{f}")
    assert int(got.corner_sharp.mask.sum()) > 20


@pytest.mark.parametrize("K", [0, 16])
def test_odo_corr_lane_axis_equals_single_lanes(K):
    """The plain odo_corr with a lane axis equals per-lane calls bit for
    bit, lanes with different valid counts and an all-sentinel lane
    included."""
    rng = np.random.default_rng(K)
    N, M0, nb = 70, 900, 2.5
    q = torch.from_numpy(rng.uniform(-5, 5, (3, N, 3)).astype(np.float32))
    xyz = torch.from_numpy(rng.uniform(-5, 5, (3, M0, 3)).astype(np.float32))
    ring = torch.from_numpy(rng.integers(0, 8, (3, M0)).astype(np.int32))
    mask = torch.from_numpy(rng.uniform(size=(3, M0)) > 0.2)
    mask[1, 500:] = False
    mask[2] = False
    xyz[0, 10] = xyz[0, 11]                            # an exact tie
    planes = toc.ref_planes(xyz, mask, ring, K)
    assert planes.shape == (3, 4, 2048 if K else 1024)
    got = toc.odo_corr_planes(q, planes, K, nb)
    for b in range(3):
        want = toc.odo_corr(q[b], xyz[b], mask[b], ring[b], K=K, nearby=nb)
        for f in want._fields:
            g, w = getattr(got, f)[b], getattr(want, f)
            assert g.dtype == w.dtype and torch.equal(g, w), (b, f)
    assert bool((got.c_idx[2] == planes.shape[-1]).all())


def test_fused_insert_no_cross_sequence_suppression():
    """Two lanes inserting into the SAME world voxel both land (the leaf
    dedup runs in a per-lane salted namespace), each only in its own
    slot range."""
    H, P = 1 << 8, 8
    fused = tvm.create_map(2 * H, P, cell_size=2.0, leaf=0.2, device="cpu")
    pt = torch.tensor([[0.55, 0.55, 0.55]])
    xyz = pt.expand(2, 1, 3)
    fused = tbp._fused_insert(fused, H, xyz, torch.ones((2, 1), dtype=bool))
    d2, nn_xyz, valid = tbp._fused_query(fused, H, xyz,
                                         torch.ones((2, 1), dtype=bool), k=1)
    for b in range(2):
        assert bool(valid[b, 0, 0]), f"lane {b}: insert was suppressed"
        torch.testing.assert_close(nn_xyz[b, 0, 0], pt[0], atol=1e-6,
                                   rtol=0)
    assert int(fused.count[:H].sum()) == 1 and int(fused.count[H:].sum()) == 1


def _seeded_points(rng, n, Bn):
    """Bn lanes of n points; lanes 0 and 1 share their points, so only
    the salt keeps both."""
    pts = rng.uniform(-6, 6, (Bn, n, 3)).astype(np.float32)
    pts[1] = pts[0]
    mask = rng.uniform(size=(Bn, n)) > 0.1
    return pts, mask


def test_salted_insert_and_per_slot_evict_bit_equal_to_jax():
    """``_fused_insert`` (salted ``insert_at_slots``) twice, then the
    per-slot ``evict_far``, on seeded inputs: every map field equals the
    JAX package's."""
    rng = np.random.default_rng(3)
    H, P, Bn = 64, 8, 3
    jmap = jvm.create_map(Bn * H, P, 1.0, 0.2)
    tmap = interop.map_from_numpy(_copy(jmap), "cpu")
    # one small compile instead of op-by-op dispatch (seconds on one core)
    jinsert = jax.jit(jbp._fused_insert, static_argnums=1)
    for step in range(2):
        pts, mask = _seeded_points(rng, 300, Bn)
        jmap = jinsert(jmap, H, jnp.asarray(pts), jnp.asarray(mask))
        tmap = tbp._fused_insert(tmap, H, torch.from_numpy(pts),
                                 torch.from_numpy(mask))
        for f in ("points", "leaf_key", "count", "n_obs"):
            np.testing.assert_array_equal(getattr(tmap, f).numpy(),
                                          np.asarray(getattr(jmap, f)),
                                          err_msg=f"insert {step} {f}")
    centers = rng.uniform(-3, 3, (Bn, 3)).astype(np.float32)
    jmap = jbp._fused_evict_far(jmap, H, jnp.asarray(centers), 5.0)
    tmap = tbp._fused_evict_far(tmap, H, torch.from_numpy(centers), 5.0)
    for f in ("points", "leaf_key", "count", "n_obs"):
        np.testing.assert_array_equal(getattr(tmap, f).numpy(),
                                      np.asarray(getattr(jmap, f)),
                                      err_msg=f"evict {f}")
    assert 0 < int(tmap.count.sum()) < 3 * 300


def test_batch_of_one_lands_near_the_single_pipeline():
    """B = 1 through ``run_batch`` lands within 0.02 m of the port's
    ``SlamPipeline`` after 4 frames (the lanes start from the empty
    features of ``init_batch_state``, the pipeline from its first scan)."""
    fcfg = JFeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=1024, max_less_flat=4096),
        mapping=MappingConfig(map_table_size=1 << 12, map_cell_capacity=16,
                              max_query_points=1024))
    world = jsyn.World.corridor(seed=0, size=12.0)
    imgs = []
    for i in range(4):
        xyz, ring = jsyn.simulate_scan(world, np.array([0.25, 0.05, 0.0]) * i,
                                       np.eye(3), n_rings=16, pts_per_ring=900,
                                       noise=0.004, seed=i)
        imgs.append(interop.ring_image_from_numpy(
            jpre.preprocess_scan(xyz, ring, fcfg, num_rings=16), "cpu"))
    state = tbp.init_batch_state(cfg, 1, n_rings=16, device="cpu")
    state, poses = tbp.run_batch(cfg, state, RingImage(
        *(torch.stack(a)[:, None] for a in zip(*imgs))))
    pipe = SlamPipeline(cfg, device="cpu")
    for i, img in enumerate(imgs):
        pipe.process_ring_image(img, 0.1 * i)
    assert poses.t.shape == (4, 1, 3) and state.frame_idx == 4
    torch.testing.assert_close(poses.t[-1, 0], pipe.pose_map.t, atol=0.02,
                               rtol=0)
    assert float(poses.t[-1, 0, 0]) > 0.5


def test_init_batch_state_raises_without_cuda():
    """The batched entry point runs on the card unless the caller asks for
    the CPU: without CUDA the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for CPU machines")
    cfg = MsfLoamConfig(features=FeatureConfig(**FEAT),
                        mapping=MappingConfig(**MAP))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbp.init_batch_state(cfg, 2, n_rings=8)
    state = tbp.init_batch_state(cfg, 2, n_rings=8, device="cpu")
    assert state.corner_map.points.shape == (2 * MAP["map_table_size"], 32, 3)
    assert state.prev_feats.full.xyz.shape == (2, 0, 3)
    assert state.pose_odom.q.shape == (2, 4) and state.frame_idx == 0
