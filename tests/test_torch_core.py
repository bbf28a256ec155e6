"""Port's SE(3) algebra, containers and numpy ingest against the JAX
package, on the same numpy-seeded inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import FeatureConfig as JFeatureConfig
from msf_loam_tpu.core import pointcloud as jpc
from msf_loam_tpu.core import se3 as jse3
from msf_loam_tpu.dataio import preprocess as jpre
from msf_loam_tpu.dataio import synthetic as jsyn
from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.core import pointcloud as tpc
from msf_loam_tpu_torch.core import se3 as tse3
from msf_loam_tpu_torch.dataio import preprocess as tpre
from msf_loam_tpu_torch.dataio import synthetic as tsyn

# float32 elementwise algebra: the two frameworks may contract or order a
# few products differently, so agreement is to a few float32 ulps of
# unit-scale values
ATOL = 2e-6

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def _rand(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _poses(rng, n):
    q = _rand(rng, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return _rand(rng, (n, 3), 5.0), q


@pytest.mark.parametrize("op", ["multiply", "rotate", "to_matrix", "exp",
                                "skew", "conjugate"])
def test_quaternion_ops_match_jax(op):
    rng = np.random.default_rng(1)
    _, q1 = _poses(rng, 32)
    _, q2 = _poses(rng, 32)
    v = _rand(rng, (32, 3), 3.0)
    theta = _rand(rng, (32, 3), 0.3)
    theta[:4] *= 1e-8                    # Taylor branch of quat_exp
    T = torch.from_numpy
    want, got = {
        "multiply": (jse3.quat_multiply(q1, q2), tse3.quat_multiply(T(q1), T(q2))),
        "rotate": (jse3.quat_rotate(q1, v), tse3.quat_rotate(T(q1), T(v))),
        "to_matrix": (jse3.quat_to_matrix(q1), tse3.quat_to_matrix(T(q1))),
        "exp": (jse3.quat_exp(theta), tse3.quat_exp(T(theta))),
        "skew": (jse3.skew(v), tse3.skew(T(v))),
        "conjugate": (jse3.quat_conjugate(q1), tse3.quat_conjugate(T(q1))),
    }[op]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL * 3)


def test_pose_algebra_matches_jax():
    rng = np.random.default_rng(2)
    (ta, qa), (tb, qb) = _poses(rng, 1), _poses(rng, 1)
    ja, jb = jse3.Pose(ta[0], qa[0]), jse3.Pose(tb[0], qb[0])
    pa = tse3.Pose(torch.from_numpy(ta[0]), torch.from_numpy(qa[0]))
    pb = tse3.Pose(torch.from_numpy(tb[0]), torch.from_numpy(qb[0]))
    pts = _rand(rng, (50, 3), 10.0)
    delta = _rand(rng, (6,), 0.1)
    pairs = [
        (ja.compose(jb).t, pa.compose(pb).t), (ja.compose(jb).q, pa.compose(pb).q),
        (ja.inverse().t, pa.inverse().t), (ja.inverse().q, pa.inverse().q),
        (ja.retract(delta).t, pa.retract(torch.from_numpy(delta)).t),
        (ja.retract(delta).q, pa.retract(torch.from_numpy(delta)).q),
        (ja.to_vec7(), pa.to_vec7()),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL * 8)
    # points at |x| <= ~40 m: float32 transform agreement to ~1e-5 m
    np.testing.assert_allclose(pa.apply(torch.from_numpy(pts)).numpy(),
                               np.asarray(ja.apply(jnp.asarray(pts))),
                               atol=2e-5)
    ident = tse3.Pose.identity("cpu")
    np.testing.assert_array_equal(ident.q.numpy(),
                                  np.asarray(jse3.Pose.identity().q))


def test_masked_xyz_sentinel_matches_jax():
    rng = np.random.default_rng(3)
    xyz = _rand(rng, (40, 3))
    mask = rng.uniform(size=40) > 0.3
    jb = jpc.PointBatch(jnp.asarray(xyz), jnp.zeros(40), jnp.zeros(40, jnp.int32),
                        jnp.asarray(mask))
    tb = tpc.PointBatch(torch.from_numpy(xyz), torch.zeros(40),
                        torch.zeros(40, dtype=torch.int32), torch.from_numpy(mask))
    np.testing.assert_array_equal(tb.masked_xyz().numpy(),
                                  np.asarray(jb.masked_xyz()))
    assert int(tb.count()) == int(jb.count())


@pytest.mark.parametrize("rings,pts,moving", [(8, 512, False), (16, 300, True)])
def test_synthetic_and_preprocess_byte_identical(rings, pts, moving):
    """Same seed -> byte-identical scans and ring images in both packages."""
    kw = dict(n_rings=rings, pts_per_ring=pts, noise=0.004, seed=7)
    if moving:
        kw.update(linear_vel=np.array([1.0, 0.2, 0.0]), yaw_rate=0.3)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t = np.array([0.5, -0.3, 0.0])
    xj, rj = jsyn.simulate_scan(jsyn.World.corridor(seed=1, size=12.0), t, R, **kw)
    xt, rt = tsyn.simulate_scan(tsyn.World.corridor(seed=1, size=12.0), t, R, **kw)
    assert xj.tobytes() == xt.tobytes() and rj.tobytes() == rt.tobytes()
    img_j = jpre.preprocess_scan(xj, rj, JFeatureConfig(max_points_per_ring=pts),
                                 num_rings=rings)
    img_t = tpre.preprocess_scan(xt, rt, FeatureConfig(max_points_per_ring=pts),
                                 num_rings=rings, device="cpu")
    for a, b in zip(img_j, img_t):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert isinstance(img_t, tpc.RingImage)
