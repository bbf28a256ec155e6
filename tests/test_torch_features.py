"""Port's feature extraction (ops/features.py, pick_rounds plain version)
against the JAX package. The JAX side runs its XLA pick rounds
(fused_picks="off"), which tests/test_pick_rounds.py pins bit-equal to the
Pallas kernel; the port's CPU path runs the plain version of its CUDA
kernel. Everything here is compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import FeatureConfig as JFeatureConfig
from msf_loam_tpu.dataio import preprocess as jpre
from msf_loam_tpu.dataio import synthetic as jsyn
from msf_loam_tpu.ops import features as jfeat
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.ops import features as tfeat
from msf_loam_tpu_torch.ops.pick_rounds import pick_rounds

CLOUDS = ("full", "corner_sharp", "corner_less_sharp", "surf_flat",
          "surf_less_flat")

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


@pytest.mark.parametrize("rings,pts", [(16, 900), (12, 900)])
def test_extract_features_bit_equal(rings, pts):
    """All five clouds bit-equal; 12 rings exercises the row padding of
    the TPU kernel's 8-row blocks on the JAX side."""
    fields = dict(max_points_per_ring=1024, max_less_flat=2048)
    jcfg = JFeatureConfig(fused_picks="off", **fields)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    xyz, ring = jsyn.simulate_scan(
        jsyn.World.corridor(seed=0, size=12.0), np.array([1.0, 0.4, 0.0]), R,
        n_rings=rings, pts_per_ring=pts, noise=0.004, seed=0)
    img = jpre.preprocess_scan(xyz, ring, jcfg, num_rings=rings)
    want = jfeat.extract_features(img, jnp.float32(0.5), jcfg)
    got = tfeat.extract_features(interop.ring_image_from_numpy(img, "cpu"),
                                 torch.tensor(0.5), FeatureConfig(**fields))
    for name in CLOUDS:
        w, g = getattr(want, name), getattr(got, name)
        for f in w._fields:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f"{name}.{f}")
    assert int(got.corner_sharp.mask.sum()) > 50
    assert int(got.surf_less_flat.mask.sum()) > 1000


def test_pick_rounds_ties_and_sentinels_bit_equal():
    """Seeded planes full of exact score ties and -1e18 sentinels: the
    plain version breaks ties toward the lowest index like lax.top_k."""
    rng = np.random.default_rng(5)
    R, W = 4, 256
    cfg = FeatureConfig(max_points_per_ring=W)
    jcfg = JFeatureConfig(max_points_per_ring=W, fused_picks="off")
    curv = rng.integers(0, 6, (R, W)).astype(np.float32) * 0.25
    pickable = rng.uniform(size=(R, W)) > 0.2
    sector = np.sort(rng.integers(0, 6, (R, W)), axis=1).astype(np.int32)
    sector[:, :5] = -1
    gap = rng.uniform(0.0, 0.08, (R, W)).astype(np.float32)
    gate = np.full((R, W), 0.3, np.float32)
    want = jfeat.run_pick_rounds(*(jnp.asarray(a) for a in
                                   (curv, pickable, sector, gap, gate)), jcfg)
    got = tfeat.run_pick_rounds(*(torch.from_numpy(a) for a in
                                  (curv, pickable, sector, gap, gate)), cfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[0] >= 0).sum()) > 20 and int((got[1] >= 0).sum()) > 10


def test_pick_rounds_wrapper_returns_kernel_layout_on_cpu():
    """The CPU path of the wrapper returns the kernel's layout:
    (n_sharp + rounds*T, R, S), (n_flat, R, S) and the (R, W) plane."""
    R, W, S = 2, 64, 3
    z = torch.full((R, W), -1e18)
    sector = torch.randint(0, S, (R, W), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    c, f, sup = pick_rounds(z, z, sector, torch.zeros((R, W), dtype=torch.int32),
                            S=S, nsup=2, n_sharp=1, n_rest=4, rest_T=3,
                            n_flat=2)
    assert c.shape == (7, R, S) and f.shape == (2, R, S)
    assert sup.shape == (R, W) and sup.dtype == torch.bool
    assert bool((c == -1).all()) and not bool(sup.any())
