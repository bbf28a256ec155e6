"""Port's odo_corr plain version against the JAX package's Pallas kernel
itself in interpret mode (K=0 edges, K=16 plane bins), at small shapes:
8 rings x 512 points. The scans come from the port's extract_features,
which tests/test_torch_features.py holds bit-equal to the JAX package's.
match_scan2scan is held to the JAX kernel path (fused_corr="on") frame by
frame in tests/test_torch_pipeline.py, where its compile is shared with
the whole frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.core.pointcloud import PointBatch as JPointBatch
from msf_loam_tpu.core.pointcloud import ScanFeatures as JScanFeatures
from msf_loam_tpu.ops.odo_corr import odo_corr_pallas
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.dataio import preprocess, synthetic
from msf_loam_tpu_torch.ops.features import extract_features
from msf_loam_tpu_torch.ops.odo_corr import odo_corr

FCFG = FeatureConfig(max_points_per_ring=512, max_less_flat=1024)

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def port_scans():
    """Two 8-ring scans 0.2 m apart as the port's ScanFeatures (CPU)."""
    world = synthetic.World.corridor(seed=0, size=12.0)
    out = []
    for t, seed in (([0.0, 0.0, 0.0], 0), ([0.2, 0.05, 0.0], 1)):
        xyz, ring = synthetic.simulate_scan(world, np.asarray(t), np.eye(3),
                                            n_rings=8, pts_per_ring=512,
                                            noise=0.004, seed=seed)
        img = preprocess.preprocess_scan(xyz, ring, FCFG, num_rings=8,
                                         device="cpu")
        out.append(extract_features(img, torch.tensor(0.0), FCFG))
    return out


def to_jax(sf):
    """The port's ScanFeatures as the JAX package's."""
    d = interop.to_numpy(sf)
    return JScanFeatures(time=jnp.asarray(d["time"]), **{
        k: JPointBatch(*(jnp.asarray(d[k][f]) for f in JPointBatch._fields))
        for k in JScanFeatures._fields if k != "time"})


@pytest.fixture(scope="module")
def scans():
    return [to_jax(s) for s in port_scans()]


def _seeded_case(q, ref_xyz, ref_mask, ref_ring):
    """The scan's own arrays (same shapes, so the compiled reference kernel
    is reused) edited into edge cases: exact duplicate reference points
    (distance ties), extra masked points, and queries whose nearest ring has
    no partner ring within the window (the 3e38 / index-M sentinel)."""
    q, xyz = np.array(q), np.array(ref_xyz)
    mask, ring = np.array(ref_mask), np.array(ref_ring)
    xyz[200:240] = xyz[100:140]
    ring[200:240] = ring[100:140]
    mask[100:240] = True
    ring[300:340] = 100
    mask[300:340] = True
    mask[::7] = False
    q[:20] = xyz[301:321]
    q[20:40] = xyz[101:121]
    return q, xyz, mask, ring


def _compare(oc, ot):
    for f in ("a_idx", "a_ring", "c_idx", "cand_idx", "cand_ring"):
        np.testing.assert_array_equal(getattr(ot, f).numpy(),
                                      np.asarray(getattr(oc, f)), err_msg=f)
    # the compiled Pallas body may contract dx*dx + dy*dy + dz*dz into fused
    # multiply-adds; the plain version rounds each product: 1e-6 relative
    for f in ("a_d2", "c_d2", "cand_d2"):
        np.testing.assert_allclose(getattr(ot, f).numpy(),
                                   np.asarray(getattr(oc, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


@pytest.mark.parametrize("K", [0, 16])
def test_odo_corr_plain_matches_pallas_interpret(K, scans):
    prev, curr = scans
    ref = prev.surf_less_flat if K else prev.corner_less_sharp
    q = curr.surf_flat.xyz if K else curr.corner_sharp.xyz
    oc = odo_corr_pallas(q, ref.masked_xyz(), ref.mask, ref.ring, K=K,
                         nearby=2.5, interpret=True)
    tref = interop.point_batch_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    ot = odo_corr(torch.from_numpy(np.array(q)), tref.masked_xyz(), tref.mask,
                  tref.ring, K=K, nearby=2.5)
    _compare(oc, ot)

    qs, rs, ms, rings = _seeded_case(q, ref.xyz, ref.mask, ref.ring)
    oc = odo_corr_pallas(jnp.asarray(qs), jnp.asarray(np.where(ms[:, None], rs, 1e6)),
                         jnp.asarray(ms), jnp.asarray(rings), K=K, nearby=2.5,
                         interpret=True)
    ot = odo_corr(torch.from_numpy(qs), torch.from_numpy(rs),
                  torch.from_numpy(ms), torch.from_numpy(rings), K=K,
                  nearby=2.5)
    _compare(oc, ot)
    assert int((ot.c_d2 >= 3e38).sum()) >= 14    # no-partner sentinel rows
