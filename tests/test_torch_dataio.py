"""The port's ingest (``msf_loam_tpu_torch.dataio``, ``runtime``, ``proto``)
against the JAX package's on the same seeded inputs, on the CPU.

No JAX program is compiled here: the JAX side's ingest is numpy, and its
few quaternion helpers run eagerly. Files and wire bytes are held equal
byte for byte (KITTI-format sequences, ROS1 bags, stream frames, PLY and
pbstream records), gravity alignment bit for bit, and the IMU stream that
``bag_from_kitti`` synthesizes in float32 quaternion algebra to 1e-6."""

import multiprocessing
import os
import sys
import threading
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from msf_loam_tpu import proto as jproto
from msf_loam_tpu.dataio import artifacts as jart
from msf_loam_tpu.dataio import kitti as jkitti
from msf_loam_tpu.dataio import npz_bag as jbag
from msf_loam_tpu.dataio import rosbag as jros
from msf_loam_tpu.dataio import stream as jstream
from msf_loam_tpu.dataio import validation as jval
from msf_loam_tpu_torch import proto as tproto
from msf_loam_tpu_torch import runtime
from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.dataio import artifacts as tart
from msf_loam_tpu_torch.dataio import kitti as tkitti
from msf_loam_tpu_torch.dataio import npz_bag as tbag
from msf_loam_tpu_torch.dataio import nsh_bag as tnsh
from msf_loam_tpu_torch.dataio import preprocess as tpre
from msf_loam_tpu_torch.dataio import rosbag as tros
from msf_loam_tpu_torch.dataio import stream as tstream
from msf_loam_tpu_torch.dataio import synthetic as tsyn
from msf_loam_tpu_torch.dataio import validation as tval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_msg(a, b):
    """Two messages of the two packages carry the same fields."""
    assert type(a).__name__ == type(b).__name__
    assert a.time == b.time
    for name in ("xyz", "ring", "acc", "gyr", "t", "q_wxyz"):
        if hasattr(a, name):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_kitti_reader_and_bag_from_kitti_match_jax(tmp_path):
    """Both writers give the same KITTI-format files; both readers the same
    frames; ``bag_from_kitti`` with synthesized IMU the same bag to 1e-6."""
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    jkitti.make_synthetic_kitti_sequence(roots["jax"], "00", n_frames=5,
                                         pts_per_ring=300, yaw_rate=0.4)
    tkitti.make_synthetic_kitti_sequence(roots["port"], "00", n_frames=5,
                                         pts_per_ring=300, yaw_rate=0.4)
    for rel in ("sequences/00/times.txt", "sequences/00/calib.txt",
                "poses/00.txt", "sequences/00/velodyne/000004.bin"):
        assert _bytes(os.path.join(roots["jax"], rel)) == \
            _bytes(os.path.join(roots["port"], rel)), rel
    js = jkitti.KittiSequence(roots["jax"], "00", n_rings=16)
    ts = tkitti.KittiSequence(roots["jax"], "00", n_rings=16)
    np.testing.assert_array_equal(js.times, ts.times)
    np.testing.assert_array_equal(js.gt_poses, ts.gt_poses)
    for a, b in zip(js.frames(), ts.frames()):
        for name in ("xyz", "intensity", "ring"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))

    out = {k: str(tmp_path / f"{k}.npz") for k in ("jax", "port")}
    jbag.bag_from_kitti(roots["jax"], "00", out["jax"], n_rings=16,
                        imu_rate=100.0, latency=0.02)
    tbag.bag_from_kitti(roots["jax"], "00", out["port"], n_rings=16,
                        imu_rate=100.0, latency=0.02)
    with np.load(out["jax"]) as zj, np.load(out["port"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert len(zj["imu_times"]) == 40 and len(zj["odom_times"]) == 5
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
            if k in ("imu_acc", "imu_gyr", "odom_q"):
                np.testing.assert_allclose(zt[k], zj[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(zt[k], zj[k])
        assert np.abs(zj["imu_gyr"][:, 2]).max() > 0.3   # it turns


def test_bag_replay_and_realtime_shedding_match_jax(tmp_path):
    """npz bags: the same file from both writers, the same global
    timestamp order, and the same shedding under an always-busy consumer."""
    paths = {}
    for name, mod in (("jax", jbag), ("port", tbag)):
        r = np.random.default_rng(0)
        w = mod.BagWriter()
        for i in range(4):
            w.add_scan(0.1 * i, r.normal(size=(50, 3)).astype(np.float32),
                       r.integers(0, 16, 50).astype(np.int32))
            w.add_odom(0.1 * i + 0.001, [0.1 * i, 0, 0], [1.0, 0, 0, 0])
        for k in range(20):
            w.add_imu(0.02 * k, [0, 0, 9.81 + 0.01 * k], [0, 0, 0.1])
        paths[name] = str(tmp_path / f"{name}.npz")
        w.save(paths[name])
    with np.load(paths["jax"]) as zj, np.load(paths["port"]) as zt:
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])
    jb, tb = jbag.Bag(paths["jax"]), tbag.Bag(paths["port"])
    assert jb.n_scans == tb.n_scans == 4
    got_j, got_t = list(jb.replay()), list(tb.replay())
    assert len(got_j) == len(got_t) == 28
    for a, b in zip(got_j, got_t):
        _same_msg(a, b)
    busy = lambda: float("inf")                      # never catches up
    rj = [(m.time, d) for m, d in jb.replay_realtime(speed=100.0,
                                                     busy_until=busy)]
    rt = [(m.time, d) for m, d in tb.replay_realtime(speed=100.0,
                                                     busy_until=busy)]
    assert rj == rt
    assert sum(d for _, d in rt) == 4                # every scan, no IMU
    assert not any(d for _, d in tb.replay_realtime(speed=100.0))


def test_ros1_bags_match_jax_byte_for_byte(tmp_path):
    """The NSH-style fixture: JAX-written single- and multi-chunk bz2 bags
    read to equal messages by both readers; the port's writer gives the
    same bytes, also with its scans cast in a process pool; a truncated
    bag gives both readers the same prefix; the npz conversion is equal;
    the port's validator accepts the bag."""
    from make_nsh_bag import build_nsh_bag

    for tag, kw in (("one", {}), ("many", dict(chunk_msgs=100))):
        jp, tp = str(tmp_path / f"j_{tag}.bag"), str(tmp_path / f"t_{tag}.bag")
        info_j = build_nsh_bag(jp, frames=6, pts_per_ring=300, **kw)
        if tag == "one":
            info_t = tnsh.build_nsh_bag(tp, frames=6, pts_per_ring=300)
        else:
            with ProcessPoolExecutor(
                    2, mp_context=multiprocessing.get_context("spawn")) as pool:
                info_t = tnsh.build_nsh_bag(tp, frames=6, pts_per_ring=300,
                                            pool=pool, **kw)
        assert info_j == info_t
        assert _bytes(jp) == _bytes(tp), tag
        mj = list(jros.read_messages(jp))
        mt = list(tros.read_messages(jp))
        assert len(mj) == len(mt) > 200
        for (topic_a, t_a, a), (topic_b, t_b, b) in zip(mj, mt):
            assert (topic_a, t_a) == (topic_b, t_b)
            _same_msg(a, b)
        if tag == "many":
            cut = str(tmp_path / "cut.bag")
            blob = _bytes(jp)
            with open(cut, "wb") as f:
                f.write(blob[: int(len(blob) * 0.6)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                nj = [(tp_, t) for tp_, t, _ in jros.read_messages(cut)]
                nt = [(tp_, t) for tp_, t, _ in tros.read_messages(cut)]
            assert nj == nt and 0 < len(nt) < len(mt)
    cj = jros.bag_to_npz(jp, str(tmp_path / "j.npz"), latency=0.02)
    ct = tros.bag_to_npz(jp, str(tmp_path / "t.npz"), latency=0.02)
    assert cj == ct == {"scan": 6, "imu": cj["imu"], "odom": 6}
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], zt[k])
    assert tnsh.validate_bag(tp)["scans_checked"] == 3


def test_stream_frames_match_jax_and_loop_back(tmp_path):
    """The wire bytes of every message type are equal, and a JAX-package
    producer feeds the port's server over a unix socket."""
    rng = np.random.default_rng(1)
    msgs = [
        (jbag.ImuMsg(0.01, np.array([0.1, 0.2, 9.8]), np.array([0, 0.01, 0.02])),
         tbag.ImuMsg(0.01, np.array([0.1, 0.2, 9.8]), np.array([0, 0.01, 0.02]))),
        (jbag.OdomMsg(0.05, np.array([1.0, 2.0, 3.0]), np.array([1.0, 0, 0, 0])),
         tbag.OdomMsg(0.05, np.array([1.0, 2.0, 3.0]), np.array([1.0, 0, 0, 0]))),
    ]
    xyz = rng.normal(size=(40, 3)).astype(np.float32)
    ring = rng.integers(0, 16, 40).astype(np.int32)
    msgs.append((jbag.ScanMsg(0.1, xyz, ring), tbag.ScanMsg(0.1, xyz, ring)))
    for j, t in msgs:
        assert jstream._encode(j) == tstream._encode(t)

    server = tstream.StreamServer(f"unix:{tmp_path}/msf.sock",
                                  accept_timeout=20)

    def produce():
        w = jstream.StreamWriter(server.address, connect_timeout=20)
        for j, _ in msgs:
            w.send(j)
        w.close()

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    got = [m for m, dropped in server.messages(wait_eof=True)]
    server.close()
    th.join(timeout=10)
    assert not th.is_alive()
    assert [type(m).__name__ for m in got] == ["ImuMsg", "OdomMsg", "ScanMsg"]
    np.testing.assert_array_equal(got[2].xyz, xyz)
    np.testing.assert_array_equal(got[2].ring, ring)
    np.testing.assert_allclose(got[0].acc, [0.1, 0.2, 9.8], rtol=1e-7)
    assert got[1].time == 0.05


def test_native_runtime_matches_numpy_ingest(tmp_path):
    """The port's C++ ingest (built into ``_build/``, not beside its source)
    against its numpy path at the JAX package's runtime-test tolerances;
    the prefetcher delivers every frame in order, each equal to
    ``preprocess_scan`` on the read-back frame."""
    if not runtime.available():
        pytest.skip("no C++ compiler: the native runtime does not build")
    assert os.path.dirname(runtime.library_path()) == runtime.BUILD_DIR
    assert os.path.basename(runtime.BUILD_DIR) == "_build"
    cfg = FeatureConfig(max_points_per_ring=1024)
    world = tsyn.World.corridor(seed=0, size=12.0)
    xyz, ring = tsyn.simulate_scan(world, np.zeros(3), np.eye(3),
                                   n_rings=16, pts_per_ring=900)
    got_xyz, got_rel, got_mask, kept = runtime.preprocess_scan(
        xyz, ring, cfg.min_range, cfg.scan_period, 16,
        cfg.max_points_per_ring)
    img = tpre.preprocess_scan(xyz, ring, cfg, 16, device="cpu")
    np.testing.assert_array_equal(got_mask, img.mask.numpy())
    np.testing.assert_allclose(got_xyz, img.xyz.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_rel, img.rel_time.numpy(), atol=1e-5)
    assert kept == int(img.mask.sum())

    root = str(tmp_path)
    tkitti.make_synthetic_kitti_sequence(root, "00", n_frames=4,
                                         pts_per_ring=400)
    back = runtime.read_kitti_bin(
        os.path.join(root, "sequences", "00", "velodyne", "000001.bin"))
    seq = tkitti.KittiSequence(root, "00", n_rings=16)
    np.testing.assert_array_equal(back[:, :3], seq.read_frame(1).xyz)
    out = list(seq.ring_images(512, device="cpu"))
    assert seq.native and [i for i, _, _ in out] == [0, 1, 2, 3]
    for idx, t, ri in out:
        f = seq.read_frame(idx)
        want = runtime.preprocess_scan(f.xyz, None, 0.3, 0.1, 16, 512)
        assert t == f.time
        np.testing.assert_array_equal(ri.xyz.numpy(), want[0])
        np.testing.assert_array_equal(ri.mask.numpy(), want[2])


def test_artifacts_validation_and_pbstream_cross_packages(tmp_path):
    """PLY and npz trajectory files equal byte for byte and read back in
    either package; gravity alignment bit-equal; the same validation
    verdicts; pbstream records written by each package read by the other,
    byte for byte, with both codecs loaded in this one process."""
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    inten = rng.uniform(size=300).astype(np.float32)
    for name, mod in (("j", jart), ("t", tart)):
        mod.save_ply(str(tmp_path / f"{name}.ply"), xyz, inten)
    assert _bytes(tmp_path / "j.ply") == _bytes(tmp_path / "t.ply")
    np.testing.assert_array_equal(tart.load_ply(str(tmp_path / "j.ply")), xyz)
    for g in ([0.1, -0.2, 9.8], [0.0, 0.0, 9.81], [3.0, 1.0, -9.0]):
        np.testing.assert_array_equal(tart.gravity_align(xyz, np.asarray(g)),
                                      jart.gravity_align(xyz, np.asarray(g)))

    times = np.arange(7) * 0.1 + 1e9
    t = rng.normal(size=(7, 3))
    q = rng.normal(size=(7, 4))
    imu = {"times": 1e9 + np.arange(30) * 0.0025,
           "angular_velocity": rng.normal(size=(30, 3)),
           "linear_acceleration": rng.normal(size=(30, 3))}
    tart.save_trajectory(str(tmp_path / "t.npz"), times, t, q, imu=imu)
    back = jart.load_trajectory(str(tmp_path / "t.npz"))
    assert sorted(back) == sorted(tart.load_trajectory(str(tmp_path / "t.npz")))
    np.testing.assert_array_equal(back["imu_angular_velocity"],
                                  imu["angular_velocity"])

    assert tproto.available() and jproto.available()
    jproto.write_pbstream(str(tmp_path / "j.pbstream"), times, t, q, imu)
    tproto.write_pbstream(str(tmp_path / "t.pbstream"), times, t, q, imu)
    assert _bytes(tmp_path / "j.pbstream") == _bytes(tmp_path / "t.pbstream")
    a = tproto.read_pbstream(str(tmp_path / "j.pbstream"))
    b = jproto.read_pbstream(str(tmp_path / "t.pbstream"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["translation"], t)

    world = tsyn.World.corridor(seed=0, size=12.0)
    sx, sr = tsyn.simulate_scan(world, np.zeros(3), np.eye(3), n_rings=16,
                                pts_per_ring=300)
    rel = tpre.compute_relative_time(sx, sr)
    bad_x = sx.copy()
    bad_x[3] = np.nan
    for args in ((sx, sr, rel, 16), (bad_x, sr + 10, -rel, 16),
                 (sx[::-1].copy(), sr[::-1].copy(), None, 16)):
        assert tval.validate_scan(*args) == jval.validate_scan(*args)
    assert tval.validate_scan(sx, sr, rel, 16)["ok"]
    np.testing.assert_array_equal(tval.restamp_latency(times),
                                  jval.restamp_latency(times))
