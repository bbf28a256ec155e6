"""The benchmark's frozen generator and ring-image code are bit-equal
to the port's at a small size."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT
from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.dataio import preprocess, synthetic
from portbench import pool, ringimage, world


def _same_world(a, b):
    for xa, xb in zip(a.planes + a.poles + a.rects,
                      b.planes + b.poles + b.rects):
        for k, v in vars(xa).items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(getattr(xb, k)))
    assert (len(a.planes), len(a.poles), len(a.rects)) == \
        (len(b.planes), len(b.poles), len(b.rects))


@pytest.mark.parametrize("distorted", [False, True])
def test_world_scan_and_drive_bit_equal(distorted):
    mine = world.World.street_grid(seed=3, n_blocks=2)
    port = synthetic.World.street_grid(seed=3, n_blocks=2)
    wps = world.street_route(n_blocks=2)
    np.testing.assert_array_equal(wps, synthetic.street_route(n_blocks=2))
    _same_world(mine, port)
    times = np.arange(12) * 0.1
    a = world.drive_states(world.VehiclePath.from_waypoints(wps, 2.0),
                           5.0, times, accel=2.0)
    b = synthetic.drive_states(synthetic.VehiclePath.from_waypoints(wps, 2.0),
                               5.0, times, accel=2.0)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    i = 7
    kw = dict(n_rings=8, pts_per_ring=300, noise=0.01, seed=5)
    if distorted:
        kw.update(linear_vel=a["v_world"][i], yaw_rate=float(a["yaw_rate"][i]))
    sa = world.simulate_scan(mine, a["p"][i], a["R"][i], **kw)
    sb = synthetic.simulate_scan(port, b["p"][i], b["R"][i], **kw)
    np.testing.assert_array_equal(sa[0], sb[0])
    np.testing.assert_array_equal(sa[1], sb[1])


def test_ring_image_bit_equal():
    w = world.World.street_grid(seed=0, n_blocks=2)
    xyz, ring = world.simulate_scan(w, np.array([1.0, 2.0, 0.0]), np.eye(3),
                                    n_rings=8, pts_per_ring=400, noise=0.01)
    cfg = FeatureConfig(max_points_per_ring=512)
    want = preprocess.preprocess_scan(xyz, ring, cfg, num_rings=8,
                                      device="cpu")
    got = ringimage.ring_image(xyz, ring, 8, 512, cfg.min_range,
                               cfg.scan_period)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_.numpy())


def test_pool_cache_keyed_by_configuration(tmp_path):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "kitti_hdl64.json")) as f:
        cfg = json.load(f)
    pool.CACHE = str(tmp_path)
    a = pool.cache_dir(cfg)
    assert a == pool.cache_dir(json.loads(json.dumps(cfg)))
    cfg["sensor"]["rings"] = 32
    assert pool.cache_dir(cfg) != a
