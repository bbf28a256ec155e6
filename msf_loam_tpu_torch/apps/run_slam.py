"""Offline and online SLAM runner: the ``msf_loam_node`` CLI analog on the
PyTorch port.

The port of the JAX package's ``apps/run_slam.py``, with the same flags,
message loop and JSON summary keys. It reads a KITTI-format sequence (the
native C++ prefetcher feeds ring images), an npz or ROS1 bag (ROS1 bags
are converted to npz next to the outputs), a live socket stream
(``--listen``) or a synthetic self-test world; pushes scans (and IMU)
through ``SlamPipeline``; fuses simulated GPS and loop closures in a
shutdown pose-graph solve; and writes the trajectory, PLY map and
pbstream artifacts.

It runs on the card (``--device cuda``, the default) and raises on a
machine without CUDA; ``--device cpu`` runs the kernels' plain PyTorch
versions. ``--profile_dir`` writes a ``torch.profiler`` Chrome trace of
the frames and the shutdown fusion. ``--map_shards N`` runs the sharded
pipeline (``parallel.sharded_pipeline``: the voxel maps split over N ranks,
lidar-only) in a world of N processes, one rank each: torchrun starts them
and rank 0 alone writes the artifacts and prints the summary.

Usage:
  python -m msf_loam_tpu_torch.apps.run_slam --kitti_root DIR --sequence 00 \\
      [--config FILE] [--max_frames N] [--sim_gps] [--output_dir DIR]
  python -m msf_loam_tpu_torch.apps.run_slam --bag run.bag --loop_closure
  python -m msf_loam_tpu_torch.apps.run_slam --selftest --device cpu
  torchrun --nproc_per_node 2 -m msf_loam_tpu_torch.apps.run_slam \
      --map_shards 2 --selftest --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("msf_loam_tpu_torch")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kitti_root", help="KITTI odometry root (sequences/, poses/)")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--bag", help="npz or ROS1 bag (scan+imu+odom streams)")
    ap.add_argument("--online", action="store_true",
                    help="replay the bag on the wall clock and DROP scans "
                         "when processing falls behind (the reference's "
                         "real-time mode)")
    ap.add_argument("--online_speed", type=float, default=1.0)
    ap.add_argument("--listen",
                    help="consume a LIVE scan/IMU stream from another "
                         "process at this address ('host:port' or "
                         "'unix:/path'; dataio/stream.py protocol) with "
                         "backlog shedding")
    ap.add_argument("--config", help="config JSON (native or reference proto-JSON)")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--n_rings", type=int, default=64)
    ap.add_argument("--sim_gps", action="store_true",
                    help="simulate 1 Hz GPS from GT + noise (_SIM_GPS)")
    ap.add_argument("--loop_closure", action="store_true",
                    help="detect revisits, scan-match loop edges, and fold "
                         "them into the final pose-graph solve")
    ap.add_argument("--loop_detector", choices=("proximity", "scan_context"),
                    default="proximity",
                    help="revisit detection: trajectory proximity, or "
                         "appearance (scan-context descriptors; yaw seeded "
                         "from the descriptor shift)")
    ap.add_argument("--loop_edge_matcher", choices=("scan", "submap"),
                    default="scan",
                    help="loop edge measurement: scan-to-scan, or scan-to-"
                         "submap (register against keyframe i's "
                         "neighbourhood)")
    ap.add_argument("--posegraph", action="store_true",
                    help="run the GPS/odometry pose-graph fusion at shutdown")
    ap.add_argument("--output_dir", default=".")
    ap.add_argument("--selftest", action="store_true",
                    help="run on a synthetic corridor world (no dataset)")
    ap.add_argument("--selftest_frames", type=int, default=12)
    ap.add_argument("--selftest_path", choices=("line", "loop"),
                    default="line",
                    help="selftest trajectory shape: 'loop' drives "
                         "out-and-back so --loop_closure has a revisit")
    ap.add_argument("--eval", action="store_true", help="print ATE vs GT")
    ap.add_argument("--save_map", action="store_true")
    ap.add_argument("--pbstream", action="store_true",
                    help="also write reference-format trajectory.pbstream")
    ap.add_argument("--profile_dir",
                    help="write a torch.profiler Chrome trace (trace.json) "
                         "of the frames and the shutdown fusion here")
    ap.add_argument("--viz_stream",
                    help="publish live state (trajectory + sampled map) "
                         "into this directory for apps/viz_stream's "
                         "polling HTML viewer")
    ap.add_argument("--viz_period", type=int, default=20,
                    help="frames between --viz_stream publishes")
    ap.add_argument("--map_shards", type=int, default=0,
                    help="shard the voxel map over N ranks (lidar-only; "
                         "run under torchrun --nproc_per_node N)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default; raises without CUDA) "
                         "or on the CPU with the kernels' plain versions")
    ap.add_argument("--quiet", action="store_true")
    return ap


def _make_pipeline(cfg, args):
    """The SlamPipeline on ``--device``, or with ``--map_shards`` the
    sharded pipeline on ``args.mesh``."""
    mesh = getattr(args, "mesh", None)
    if mesh is not None:
        from msf_loam_tpu_torch.parallel.sharded_pipeline import \
            ShardedSlamPipeline
        return ShardedSlamPipeline(cfg, mesh)
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline
    return SlamPipeline(cfg, device=args.device)


def _shard_mesh(ap, args):
    """The (1, N) mesh of ``--map_shards N``: the process group started
    from torchrun's environment, its size N, one rank a process. Returns
    (mesh, whether this call started the group)."""
    import torch.distributed as dist

    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import runtime
    started = not dist.is_initialized()
    runtime.initialize(device=args.device)
    world = dist.get_world_size()
    if world != args.map_shards:
        if started:
            runtime.shutdown()
        ap.error(f"--map_shards {args.map_shards} needs a world of "
                 f"{args.map_shards} ranks; this one has {world}: run "
                 f"torchrun --nproc_per_node {args.map_shards} -m "
                 f"msf_loam_tpu_torch.apps.run_slam ...")
    return mesh_mod.make_mesh(n_map=args.map_shards,
                              device=args.device), started


def _tree_to(x, device):
    """A tensor, or a NamedTuple of them (ScanFeatures), on ``device``."""
    if torch.is_tensor(x):
        return x.to(device)
    return type(x)(*(_tree_to(a, device) for a in x))


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _close_loops(cfg, poses, data, traj, keyframes, logger, device,
                 detector="proximity", edge_matcher="scan"):
    """Detect revisits among the keyframe snapshots (kept in host memory),
    scan-match each candidate pair on ``device`` into a loop edge, and
    solve the pose graph with the edges folded in."""
    from msf_loam_tpu_torch.core.se3 import Pose, quat_exp
    from msf_loam_tpu_torch.slam import scan_context as sc
    from msf_loam_tpu_torch.slam.loop_closure import (LoopEdge,
                                                      SparsePoseGraph,
                                                      detect_loops,
                                                      match_loop_pair,
                                                      match_loop_pair_submap)

    pg = cfg.posegraph
    kf_idx = sorted(keyframes)
    stride = max(1, pg.loop_keyframe_stride)
    gap_kf = max(1, pg.loop_min_index_gap // stride)
    guesses = {}
    if detector == "scan_context":
        descs = torch.stack([sc.compute_descriptor(
            keyframes[k].full.xyz.to(device),
            keyframes[k].full.mask.to(device)) for k in kf_idx])
        triples = sc.detect_loops_scan_context(
            descs.cpu().numpy(), min_index_gap=gap_kf,
            max_dist=pg.loop_sc_max_dist, max_loops=pg.loop_max_count,
            suppress_gap=max(1, gap_kf // 2),
            # the ring-key prescreen pays off once the full N^2 x S
            # shifted scoring dominates (KITTI-scale keyframe sets)
            prescreen=0 if len(kf_idx) < 100 else 25, device=device)
        pairs = [(a, b) for a, b, _ in triples]
        for a, b, yaw in triples:
            # appearance seed: same place, heading differs by the
            # descriptor's column shift (valid under arbitrary drift)
            guesses[(a, b)] = Pose(t=torch.zeros(3, device=device),
                                   q=quat_exp(_f32([0.0, 0.0, yaw], device)))
    else:
        pairs = detect_loops(
            traj[kf_idx, 1:4], max_dist=pg.loop_max_dist,
            min_index_gap=gap_kf, max_loops=pg.loop_max_count,
            suppress_gap=max(1, gap_kf // 2))

    def pose_of(f):
        return Pose(t=_f32(traj[f, 1:4], device), q=_f32(traj[f, 4:8], device))

    graph = SparsePoseGraph(pad_loops=pg.loop_max_count)
    for a, b in pairs:
        fi, fj = kf_idx[a], kf_idx[b]
        pose_i, pose_j = pose_of(fi), pose_of(fj)
        feats_j = _tree_to(keyframes[fj], device)
        if edge_matcher == "submap":
            guess = guesses.get((a, b))
            if guess is None:
                guess = pose_i.inverse().compose(pose_j)
            neighbors = [(_tree_to(keyframes[fn], device),
                          pose_i.inverse().compose(pose_of(fn)))
                         for fn in (fi - stride, fi, fi + stride)
                         if fn in keyframes]
            rel, ok = match_loop_pair_submap(neighbors, feats_j, guess, cfg)
        else:
            rel, ok = match_loop_pair(
                _tree_to(keyframes[fi], device), feats_j, pose_i, pose_j,
                cfg, guess=guesses.get((a, b)))
        if bool(ok):
            graph.add_edge(LoopEdge(fi, fj, rel.t.cpu().numpy(),
                                    rel.q.cpu().numpy()))
            logger.info("loop edge %d <-> %d", fi, fj)
        else:
            logger.info("loop candidate %d <-> %d rejected by matcher",
                        fi, fj)
    out = graph.optimize(poses, data, pg, n_iters=pg.iterations)
    return out, len(graph.edges)


def main(argv=None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_slam --device cuda (the default) needs a "
                           "CUDA device; pass --device cpu to run the plain "
                           "PyTorch versions of the kernels")
    args.mesh, started = _shard_mesh(ap, args) if args.map_shards else (
        None, False)
    try:
        return _run(args, args.mesh)
    finally:
        if started:
            from msf_loam_tpu_torch.parallel import runtime
            runtime.shutdown()


def _run(args, mesh) -> int:
    root = mesh is None or mesh.rank == 0
    logging.basicConfig(
        level=logging.WARNING if args.quiet or not root else logging.INFO,
        format="%(levelname).1s %(asctime)s %(name)s] %(message)s")
    verbose = logger.isEnabledFor(logging.INFO)
    dev = torch.device(args.device) if mesh is None else mesh.device

    from msf_loam_tpu_torch.config import MsfLoamConfig
    from msf_loam_tpu_torch.dataio import artifacts, preprocess
    from msf_loam_tpu_torch.slam.pipeline import ate_rmse

    cfg = MsfLoamConfig.from_json(args.config) if args.config \
        else MsfLoamConfig()

    t_start = time.perf_counter()
    gt_t = []
    gps_times, gps_xyz = [], []
    rng = np.random.default_rng(0)

    keyframes = {}  # frame index -> ScanFeatures snapshot in host memory

    viz = None
    if args.viz_stream and root:
        from msf_loam_tpu_torch.apps.viz_stream import VizStreamWriter
        viz = VizStreamWriter(args.viz_stream, period=args.viz_period)

    def maybe_keyframe(pipe):
        """Per-frame host hooks: loop-closure keyframe snapshots every
        loop_keyframe_stride frames, live-viz publish every viz_period."""
        if viz is not None:
            viz.add_frame(pipe)
        if not args.loop_closure or pipe.prev_scan is None:
            return
        idx = len(pipe.results) - 1
        if idx % cfg.posegraph.loop_keyframe_stride == 0:
            keyframes[idx] = _tree_to(pipe.prev_scan, "cpu")

    prof = None
    if args.profile_dir and root:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()

    if args.selftest:
        from msf_loam_tpu_torch.dataio import synthetic
        n_rings = 16
        fcfg = dataclasses.replace(cfg.features, max_points_per_ring=2048)
        cfg = dataclasses.replace(cfg, features=fcfg)
        pipe = _make_pipeline(cfg, args)
        world = synthetic.World.corridor(seed=0, size=12.0)
        n = args.selftest_frames
        for i in range(n):
            if args.selftest_path == "loop":
                # out-and-back (no turn): the tail revisits the head
                fwd = i if i < n // 2 else (n - 1 - i)
                t = np.array([0.25 * fwd, 0.0, 0.0])
                yaw = 0.0
            else:
                t = np.array([0.25 * i, 0.1 * np.sin(0.2 * i), 0.0])
                yaw = 0.02 * i
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
            xyz, ring = synthetic.simulate_scan(world, t, R, n_rings=n_rings,
                                                pts_per_ring=1800,
                                                noise=0.004, seed=i)
            img = preprocess.preprocess_scan(xyz, ring, cfg.features,
                                             n_rings, device=dev)
            res = pipe.process_ring_image(img, 0.1 * i)
            maybe_keyframe(pipe)
            gt_t.append(t)
            if args.sim_gps and i % cfg.posegraph.sim_gps_period == 0:
                gps_times.append(0.1 * i)
                gps_xyz.append(t + rng.uniform(-cfg.posegraph.sim_gps_noise,
                                               cfg.posegraph.sim_gps_noise, 3))
            if verbose:
                logger.info("frame %d: t=%s ok=%s", i,
                            np.round(res.map_pose.t.cpu().numpy(), 3), res.ok)
    elif args.bag or args.listen:
        # bag replay (the reference's offline rosbag loop) or live stream
        # ingest (--listen: the live-topics mode): one message loop, one
        # shedding policy
        from msf_loam_tpu_torch.dataio.npz_bag import (Bag, ImuMsg, OdomMsg,
                                                       ScanMsg)
        bag_path = args.bag
        is_rosbag = False
        if bag_path:
            with open(bag_path, "rb") as _f:
                is_rosbag = _f.read(13) == b"#ROSBAG V2.0\n"
        if is_rosbag:
            # ROS1 bag: convert with the pure-Python reader, cached next to
            # the outputs
            from msf_loam_tpu_torch.dataio.rosbag import bag_to_npz
            os.makedirs(args.output_dir, exist_ok=True)
            conv = os.path.join(
                args.output_dir,
                os.path.splitext(os.path.basename(bag_path))[0]
                + ".converted.npz")
            if not os.path.exists(conv):
                counts = bag_to_npz(bag_path, conv)
                logger.info("converted ROS bag %s -> %s (%s)", bag_path,
                            conv, counts)
            bag_path = conv
        pipe = _make_pipeline(cfg, args)
        counter = 0
        n_scans = 0
        n_dropped = 0
        gt_stamped = []
        busy_holder = [0.0]
        server = None
        if args.listen:
            from msf_loam_tpu_torch.dataio.stream import StreamServer
            server = StreamServer(args.listen)
            logger.info("listening for scan/IMU stream on %s",
                        server.address)
            messages = server.messages
        else:
            bag = Bag(bag_path)
            if args.online:
                # online mode: wall-clock replay with backlog shedding
                stream = bag.replay_realtime(
                    speed=args.online_speed,
                    busy_until=lambda: busy_holder[0])

                def messages():
                    for msg, dropped in stream:
                        yield msg, dropped
            else:
                def messages():
                    for msg in bag.replay():
                        yield msg, False

        def do_scan(msg):
            nonlocal n_scans
            if args.max_frames and n_scans >= args.max_frames:
                return
            t_proc0 = time.perf_counter()
            img = preprocess.preprocess_scan(
                msg.xyz, msg.ring, cfg.features, args.n_rings, device=dev)
            res = pipe.process_ring_image(img, msg.time)
            maybe_keyframe(pipe)
            if args.online:
                busy_holder[0] = time.perf_counter() + \
                    0.5 * (time.perf_counter() - t_proc0)
            n_scans += 1
            if verbose:
                logger.info("scan @%.2f: t=%s", msg.time,
                            np.round(res.map_pose.t.cpu().numpy(), 2))

        # IMU/scan sync: a scan's deskew window spans [t, t+scan_period],
        # so with an active IMU stream each scan is HELD until IMU coverage
        # through its window end has arrived (messages replay in timestamp
        # order, so processing a scan the moment it appears would always
        # find an empty window)
        pending_scans = []
        last_scan_t = [-np.inf]

        def flush_scans(force=False):
            while pending_scans:
                deadline = pending_scans[0].time + cfg.features.scan_period
                if not force and len(pipe.imu_buffer) and \
                        pipe.imu_buffer.times[-1] < deadline:
                    break
                do_scan(pending_scans.pop(0))

        for msg, dropped in messages():
            if isinstance(msg, ImuMsg):
                pipe.add_imu(msg.time, msg.acc, msg.gyr)
                flush_scans()
            elif isinstance(msg, OdomMsg):
                gt_stamped.append((msg.time, msg.t))
                counter += 1
                if args.sim_gps and counter % cfg.posegraph.sim_gps_period == 0:
                    gps_times.append(msg.time)
                    gps_xyz.append(msg.t + rng.uniform(
                        -cfg.posegraph.sim_gps_noise,
                        cfg.posegraph.sim_gps_noise, 3))
            elif isinstance(msg, ScanMsg):
                if dropped:
                    n_dropped += 1
                    logger.warning("[MAP] drop lidar frame @%.2f for real "
                                   "time performance", msg.time)
                    continue
                if msg.time <= last_scan_t[0]:
                    # out-of-order arrival (network reordering on
                    # --listen): a backward time step would corrupt the
                    # IMU window slicing, so drop it
                    n_dropped += 1
                    logger.warning("[MAP] drop out-of-order lidar frame "
                                   "@%.2f (<= %.2f)", msg.time,
                                   last_scan_t[0])
                    continue
                last_scan_t[0] = msg.time
                if args.max_frames and n_scans >= args.max_frames:
                    continue
                if len(pipe.imu_buffer):
                    pending_scans.append(msg)
                    flush_scans()
                else:
                    do_scan(msg)           # lidar-only bag: no sync needed
        flush_scans(force=True)
        if server is not None:
            server.close()
        # align gt with the scans actually PROCESSED (nearest timestamp):
        # under online/stream shedding a dropped scan drops its gt row too
        if gt_stamped and pipe.results:
            g_times = np.asarray([g[0] for g in gt_stamped])
            g_pos = np.asarray([g[1] for g in gt_stamped])
            for r in pipe.results:
                gt_t.append(g_pos[int(np.argmin(np.abs(g_times - r.time)))])
    else:
        if not args.kitti_root:
            print("error: --kitti_root, --bag or --selftest required",
                  file=sys.stderr)
            return 2
        from msf_loam_tpu_torch.dataio.kitti import KittiSequence
        seq = KittiSequence(args.kitti_root, args.sequence,
                            n_rings=args.n_rings)
        pipe = _make_pipeline(cfg, args)
        end = args.max_frames or len(seq)
        counter = 0
        # the native C++ prefetcher feeds preprocessed ring images
        for index, t_scan, img in seq.ring_images(
                cfg.features.max_points_per_ring, cfg.features.min_range,
                cfg.features.scan_period, end=end, device=dev):
            res = pipe.process_ring_image(img, t_scan)
            maybe_keyframe(pipe)
            if seq.gt_poses is not None:
                gt_pose = seq.gt_poses[index]
                gt_t.append(gt_pose[:3, 3])
                counter += 1
                if args.sim_gps and counter % cfg.posegraph.sim_gps_period == 0:
                    gps_times.append(t_scan)
                    gps_xyz.append(gt_pose[:3, 3] + rng.uniform(
                        -cfg.posegraph.sim_gps_noise,
                        cfg.posegraph.sim_gps_noise, 3))
            if verbose:
                logger.info("frame %d: t=%s corr=%d", index,
                            np.round(res.map_pose.t.cpu().numpy(), 2),
                            int(res.n_correspondences))

    if viz is not None:
        viz.publish(pipe, done=True)

    whole_surf = None
    if mesh is not None and args.save_map:
        # every rank takes part in the gather of the whole map
        from msf_loam_tpu_torch.parallel.sharded_map import gather_map
        whole_surf = gather_map(mesh, pipe.surf_map)
    if not root:
        return 0

    traj = pipe.trajectory()
    elapsed = time.perf_counter() - t_start
    n_frames = len(traj)
    summary = {
        "frames": n_frames,
        "elapsed_s": round(elapsed, 2),
        "scans_per_sec": round(n_frames / elapsed, 2),
    }
    if (args.bag and args.online) or args.listen:
        summary["dropped_scans"] = n_dropped

    # shutdown-time pose-graph fusion (the LaserMapping destructor's)
    run_pg = args.posegraph and len(gps_times) >= 2
    run_lc = args.loop_closure and len(keyframes) >= 2
    if run_pg or run_lc:
        from msf_loam_tpu_torch.core.se3 import Pose
        from msf_loam_tpu_torch.slam import posegraph
        poses = Pose(t=_f32(traj[:, 1:4], dev), q=_f32(traj[:, 4:8], dev))
        if run_pg:
            g_times = _f32(gps_times, dev)
            g_xyz = _f32(gps_xyz, dev)
            g_valid = torch.ones(len(gps_times), dtype=torch.bool,
                                 device=dev)
        else:  # placeholder row; invalid, so inert
            g_times = torch.zeros(1, device=dev)
            g_xyz = torch.zeros((1, 3), device=dev)
            g_valid = torch.zeros(1, dtype=torch.bool, device=dev)
        data = posegraph.build_graph_data(_f32(traj[:, 0], dev), poses,
                                          g_times, g_xyz, g_valid)
        # pad to a size class, as the JAX package does to reuse programs
        n_real = len(traj)
        poses, data = posegraph.pad_graph(
            poses, data, posegraph.next_bucket(n_real))
        if run_lc:
            out, n_edges = _close_loops(cfg, poses, data, traj, keyframes,
                                        logger, dev,
                                        detector=args.loop_detector,
                                        edge_matcher=args.loop_edge_matcher)
            summary["loop_edges"] = n_edges
        else:
            out = posegraph.optimize(poses, data, cfg.posegraph,
                                     n_iters=cfg.posegraph.iterations)
        traj[:, 1:4] = out.poses.t[:n_real].cpu().numpy()
        traj[:, 4:8] = out.poses.q[:n_real].cpu().numpy()
        summary["posegraph_cost"] = [float(out.initial_cost),
                                     float(out.final_cost)]

    if prof is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.__exit__(None, None, None)
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))

    os.makedirs(args.output_dir, exist_ok=True)
    artifacts.save_trajectory(
        os.path.join(args.output_dir, cfg.runtime.trajectory_output),
        traj[:, 0], traj[:, 1:4], traj[:, 4:8])
    if args.pbstream:
        # reference-wire-format record (trajectory.pbstream)
        from msf_loam_tpu_torch import proto as pbcodec
        if pbcodec.available():
            imu_rec = None
            n_imu = len(pipe.imu_buffer)
            if n_imu:
                imu_rec = {
                    "times": pipe.imu_buffer.times,
                    "angular_velocity": pipe.imu_buffer._gyr[:n_imu],
                    "linear_acceleration": pipe.imu_buffer._acc[:n_imu],
                }
            pbcodec.write_pbstream(
                os.path.join(args.output_dir, "trajectory.pbstream"),
                traj[:, 0], traj[:, 1:4], traj[:, 4:8], imu_rec)
            summary["pbstream"] = True

    if args.save_map:
        surf = pipe.surf_map if whole_surf is None else whole_surf
        stored = surf.points.reshape(-1, 3).cpu().numpy()
        occ = (np.arange(surf.slab_capacity)[None, :]
               < surf.count.cpu().numpy()[:, None]).reshape(-1)
        cloud = stored[occ]
        if pipe.is_initialized:
            cloud = artifacts.gravity_align(cloud, pipe.gravity.cpu().numpy())
        artifacts.save_ply(os.path.join(args.output_dir,
                                        cfg.runtime.map_output), cloud)
        summary["map_points"] = int(occ.sum())

    if args.eval and gt_t:
        gt = np.asarray(gt_t)
        gt_rel = gt - gt[0]
        summary["ate_rmse_m"] = round(ate_rmse(traj[:, 1:4], gt_rel), 4)
        summary["ate_rmse_aligned_m"] = round(
            ate_rmse(traj[:, 1:4], gt_rel, align=True), 4)

    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
