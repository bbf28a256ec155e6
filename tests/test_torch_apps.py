"""The port's apps (``msf_loam_tpu_torch.apps``) against the JAX
package's, on the CPU.

* ``run_slam``'s message loop: both ``main()``s drive a recording fake
  pipeline (``_make_pipeline`` patched) and a recording pose graph over
  one npz bag; the calls, the simulated GPS draws and the summary are
  equal.
* ``run_slam --kitti_root`` at 64 rings: both apps end to end, JAX on its
  kernel path (Pallas in interpret mode, XLA pick rounds), the port with
  ``--device cpu`` (the kernels' plain versions); trajectories within
  1e-4 m. This is the file's one JAX compile.
* ``evaluate``, ``export_viz`` and ``viz_stream`` give the same outputs
  from the same files and state.
* ``--map_shards 2`` and a default-device run without CUDA end in an
  error, not a silent fallback.
"""

import hashlib
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msf_loam_tpu.slam.posegraph as jpg
import msf_loam_tpu_torch.slam.posegraph as tpg
from msf_loam_tpu.apps import evaluate as jeval
from msf_loam_tpu.apps import export_viz as jviz
from msf_loam_tpu.apps import run_slam as jrun
from msf_loam_tpu.apps import viz_stream as jstream
from msf_loam_tpu.imu.buffer import ImuBuffer as JImuBuffer
from msf_loam_tpu_torch.apps import evaluate as teval
from msf_loam_tpu_torch.apps import export_viz as tviz
from msf_loam_tpu_torch.apps import run_slam as trun
from msf_loam_tpu_torch.apps import viz_stream as tstream
from msf_loam_tpu_torch.dataio import artifacts, kitti, npz_bag, synthetic
from msf_loam_tpu_torch.imu.buffer import ImuBuffer as TImuBuffer

torch.set_num_threads(1)
TIMING = ("elapsed_s", "scans_per_sec")


class _FakePipeline:
    """Records what the app feeds a pipeline; poses advance 0.1 m a frame.
    ``tensor`` makes the package's pose arrays (numpy for JAX, torch for
    the port)."""

    def __init__(self, imu_buffer, tensor):
        self.calls = []
        self.imu_buffer = imu_buffer
        self.results = []
        self.prev_scan = None
        self.is_initialized = False
        self._tensor = tensor

    def add_imu(self, t, acc, gyr):
        self.calls.append(("imu", t, list(np.asarray(acc, np.float64)),
                           list(np.asarray(gyr, np.float64))))
        self.imu_buffer.add(t, acc, gyr)

    def process_ring_image(self, img, t):
        planes = [np.asarray(a) for a in img]
        self.calls.append(("scan", t, [p.dtype.str for p in planes],
                           hashlib.sha1(b"".join(p.tobytes() for p in planes))
                           .hexdigest()))
        k = len(self.results)
        pose = types.SimpleNamespace(
            t=self._tensor(np.array([0.1 * k, 0.0, 0.0], np.float32)),
            q=self._tensor(np.array([1.0, 0.0, 0.0, 0.0], np.float32)))
        res = types.SimpleNamespace(time=t, map_pose=pose, ok=True,
                                    n_correspondences=100.0)
        self.results.append(res)
        return res

    def trajectory(self):
        return np.asarray([[r.time, 0.1 * k, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
                           for k, r in enumerate(self.results)])


def _record_posegraph(monkeypatch, mod, seen):
    """Replace the pose graph with a recorder: the GPS fixes the app passes,
    the padding, and an identity solve."""
    def build_graph_data(times, poses, g_times, g_xyz, g_valid):
        seen["gps"] = [np.asarray(a).tolist() for a in (g_times, g_xyz,
                                                        g_valid)]
        seen["times"] = np.asarray(times).tolist()
        return "data"

    def pad_graph(poses, data, to_n):
        seen["bucket"] = to_n
        return poses, data

    def optimize(poses, data, cfg, n_iters=10):
        seen["iters"] = n_iters
        return types.SimpleNamespace(poses=poses, initial_cost=2.0,
                                     final_cost=1.0)

    for name, fn in (("build_graph_data", build_graph_data),
                     ("pad_graph", pad_graph), ("optimize", optimize)):
        monkeypatch.setattr(mod, name, fn)


def test_run_slam_message_loop_matches_jax(tmp_path, monkeypatch, capsys):
    """An npz bag with 200 Hz IMU, odometry, a scan whose stamp repeats
    (dropped as out of order) and --max_frames: both apps hold scans for
    IMU coverage and feed the same add_imu / process_ring_image calls in
    the same order, draw the same GPS fixes, print the same summary and
    write the same pbstream (with the IMU record) and viz state."""
    monkeypatch.setenv("MSF_JAX_CACHE", "0")
    rng = np.random.default_rng(0)
    w = npz_bag.BagWriter()
    world = synthetic.World.corridor(seed=0, size=12.0)
    stamps = [0.1 * i for i in range(8)]
    stamps.insert(4, stamps[3])                       # out of order: dropped
    for i, t in enumerate(stamps):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.1 * i, 0.0, 0.0]), np.eye(3), n_rings=16,
            pts_per_ring=120, noise=0.004, seed=i)
        w.add_scan(t, xyz, ring)
        w.add_odom(t, [0.1 * i, 0.02 * i, 0.0], [1.0, 0.0, 0.0, 0.0])
    for k in range(170):
        w.add_imu(0.005 * k, rng.normal(size=3) + [0, 0, 9.81],
                  rng.normal(size=3) * 0.1)
    bag = str(tmp_path / "run.npz")
    w.save(bag)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"posegraph": {"sim_gps_period": 2}}))
    argv = ["--bag", bag, "--n_rings", "16", "--max_frames", "5",
            "--sim_gps", "--posegraph", "--eval", "--quiet", "--pbstream",
            "--viz_period", "2", "--config", str(cfg)]

    runs = {}
    for name, app, pg, buf, tensor, dev in (
            ("jax", jrun, jpg, JImuBuffer, jnp.asarray, []),
            ("port", trun, tpg, TImuBuffer, torch.from_numpy,
             ["--device", "cpu"])):
        fake = _FakePipeline(buf(), tensor)
        monkeypatch.setattr(app, "_make_pipeline", lambda cfg, args: fake)
        seen = {}
        _record_posegraph(monkeypatch, pg, seen)
        assert app.main(argv + dev + [
            "--output_dir", str(tmp_path / name),
            "--viz_stream", str(tmp_path / name / "viz")]) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[name] = (fake.calls, seen, summary)
    (jcalls, jseen, jsum), (tcalls, tseen, tsum) = runs["jax"], runs["port"]
    assert tcalls == jcalls
    assert sum(c[0] == "scan" for c in tcalls) == 5
    assert [c[1] for c in tcalls if c[0] == "scan"] == stamps[:4] + stamps[5:6]
    assert tseen == jseen and len(tseen["gps"][0]) == 4
    for k in TIMING:
        jsum.pop(k), tsum.pop(k)
    assert tsum == jsum
    assert tsum["posegraph_cost"] == [2.0, 1.0] and tsum["frames"] == 5
    for rel in ("trajectory.pbstream", "viz/state.json", "viz/viz_live.html"):
        with open(tmp_path / "jax" / rel, "rb") as fj, \
                open(tmp_path / "port" / rel, "rb") as ft:
            assert fj.read() == ft.read(), rel
    jt, tt = (artifacts.load_trajectory(str(tmp_path / n / "trajectory.npz"))
              for n in ("jax", "port"))
    assert sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(jt[k], tt[k])


def test_run_slam_kitti_64_rings_matches_jax(tmp_path, monkeypatch, capsys):
    """A 3-frame, 64-ring KITTI-format sequence (900 points a ring)
    through both apps with --save_map --pbstream; the trajectories agree
    within 1e-4 m and the artifacts read back in the port."""
    monkeypatch.setenv("MSF_JAX_CACHE", "0")
    root = str(tmp_path / "kitti64")
    kitti.make_synthetic_kitti_sequence(
        root, "00", n_frames=3, n_rings=64, pts_per_ring=900,
        world=synthetic.World.corridor(seed=2, size=15.0))
    # the JAX side on its kernel path (fused_corr / fused_select "on",
    # Pallas in interpret mode; XLA pick rounds, bit-equal to its kernel);
    # narrowed maps and queries keep its compile short (the port ignores
    # the fused_* switches: it always runs its kernels)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "features": {"max_points_per_ring": 1024, "max_less_flat": 2048,
                     "fused_picks": "off"},
        "odometry": {"fused_corr": "on"},
        "mapping": {"fused_select": "on", "map_table_size": 4096,
                    "max_query_points": 512, "max_corner_query_points": 256,
                    "gather_groups": 128}}))
    argv = ["--kitti_root", root, "--n_rings", "64", "--eval", "--quiet",
            "--save_map", "--pbstream", "--config", str(cfg)]
    out = {}
    for name, app, extra in (("jax", jrun, []),
                             ("port", trun, ["--device", "cpu"])):
        odir = str(tmp_path / name)
        assert app.main(argv + extra + ["--output_dir", odir]) == 0
        out[name] = (json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]), odir)
    (js, jdir), (ts, tdir) = out["jax"], out["port"]
    assert ts["frames"] == js["frames"] == 3 and ts["pbstream"]
    assert abs(ts["ate_rmse_m"] - js["ate_rmse_m"]) <= 1e-4
    assert ts["ate_rmse_m"] < 0.1
    jt = artifacts.load_trajectory(os.path.join(jdir, "trajectory.npz"))
    tt = artifacts.load_trajectory(os.path.join(tdir, "trajectory.npz"))
    np.testing.assert_array_equal(tt["times"], jt["times"])
    np.testing.assert_allclose(tt["translation"], jt["translation"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(tt["rotation_wxyz"], jt["rotation_wxyz"],
                               rtol=0, atol=1e-4)
    assert float(np.abs(tt["translation"][-1]).max()) > 0.4   # it moved
    from msf_loam_tpu_torch import proto
    pb = proto.read_pbstream(os.path.join(jdir, "trajectory.pbstream"))
    np.testing.assert_allclose(pb["translation"], tt["translation"], rtol=0,
                               atol=1e-4)
    # map insert hashes poses equal to ~1e-6 m: a point changes leaf voxel
    # only at a boundary, so the map sizes agree to 0.5%
    jm = artifacts.load_ply(os.path.join(jdir, "msf_loam_cloud.ply"))
    tm = artifacts.load_ply(os.path.join(tdir, "msf_loam_cloud.ply"))
    assert len(tm) == ts["map_points"] and len(jm) == js["map_points"]
    assert abs(len(tm) - len(jm)) <= 0.005 * len(jm) + 1


def test_evaluate_export_viz_and_viz_stream_match_jax(tmp_path, capsys):
    rng = np.random.default_rng(4)
    n = 40
    gt_t = np.cumsum(rng.normal(size=(n, 3)) * [1.0, 0.5, 0.05], axis=0)
    yaw = np.cumsum(rng.normal(size=n) * 0.05)
    gt_q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
    est_t = gt_t + rng.normal(size=gt_t.shape) * 0.05
    est_q = gt_q + rng.normal(size=gt_q.shape) * 0.01
    est, gt = str(tmp_path / "est.npz"), str(tmp_path / "gt.npz")
    artifacts.save_trajectory(est, np.arange(n) * 0.1, est_t, est_q)
    artifacts.save_trajectory(gt, np.arange(n) * 0.1, gt_t, gt_q)
    ply = str(tmp_path / "map.ply")
    artifacts.save_ply(ply, rng.normal(size=(500, 3)).astype(np.float32) * 9)
    root = str(tmp_path / "kitti")
    kitti.make_synthetic_kitti_sequence(root, "00", n_frames=14,
                                        pts_per_ring=40, yaw_rate=0.2)
    for args in (["--trajectory", est, "--gt_npz", gt],
                 ["--trajectory", est, "--gt_npz", gt, "--rpe_delta", "3"],
                 ["--trajectory", est, "--kitti_root", root]):
        outs = []
        for main in (jeval.main, teval.main):
            assert main(args) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
        assert "rpe_" in outs[1]
    htmls = []
    for name, main in (("j", jviz.main), ("t", tviz.main)):
        html = str(tmp_path / f"{name}.html")
        assert main(["--trajectory", est, "--map", ply, "--output", html,
                     "--max_points", "300"]) == 0
        htmls.append((capsys.readouterr().out.replace(html, "X"),
                      open(html).read()))
    assert htmls[0] == htmls[1]

    points = rng.normal(size=(64, 8, 3)).astype(np.float32)
    count = rng.integers(0, 9, 64).astype(np.int32)
    states = []
    for name, mod, tensor in (("j", jstream, jnp.asarray),
                              ("t", tstream, torch.from_numpy)):
        d = str(tmp_path / f"viz_{name}")
        writer = mod.VizStreamWriter(d, period=3)
        pipe = types.SimpleNamespace(
            results=[], surf_map=types.SimpleNamespace(
                points=tensor(points), count=tensor(count)))
        for k in range(7):
            pipe.results.append(types.SimpleNamespace(
                map_pose=types.SimpleNamespace(
                    t=tensor(est_t[k].astype(np.float32)))))
            writer.add_frame(pipe)
        writer.publish(pipe, done=True)
        states.append([open(os.path.join(d, f)).read()
                       for f in ("state.json", "viz_live.html")])
    assert states[0] == states[1]
    state = json.loads(states[1][0])
    assert state["done"] and state["frame"] == 7 and len(state["traj"]) == 21


@pytest.mark.parametrize("case", ["map_shards", "default_device"])
def test_run_slam_refuses_what_it_cannot_run(case, tmp_path, capsys):
    """--map_shards 2 in a world of one process exits with an error that
    names torchrun (the sharded map needs one rank a shard); without CUDA
    the default device raises instead of running on the CPU."""
    argv = ["--selftest", "--selftest_frames", "2", "--quiet",
            "--output_dir", str(tmp_path)]
    if case == "map_shards":
        with pytest.raises(SystemExit) as e:
            trun.main(argv + ["--map_shards", "2", "--device", "cpu"])
        assert e.value.code == 2
        assert "torchrun --nproc_per_node 2" in capsys.readouterr().err
    else:
        if torch.cuda.is_available():
            pytest.skip("this machine has CUDA; the check is for CPU machines")
        with pytest.raises(RuntimeError, match="CUDA"):
            trun.main(argv)
    assert not os.path.exists(tmp_path / "trajectory.npz")
