#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (msf_loam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. build the five hand-written CUDA kernels from ``msf_loam_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. kernels against their plain PyTorch versions on the card:
   * pick_rounds, odo_corr, select_fit on every call of one real frame of
     the full-width lidar-only pipeline (16 rings x 1800 points, 32k-slot
     maps); pick_rounds bit-equal; odo_corr indices and rings exact, d2
     bit-equal; select_fit d2 bit-equal, centres within 1e-4 m, normals
     within 1e-4 of parallel, validity equal except where a plain gate
     value lies within 1e-5 (relative) of its threshold; each mapping
     round's pair launch (line + plane2 in one launch,
     ``select_fit_pair``) against its two plain calls, and each of its
     halves alone;
   * seeded adversarial cases, bit-equal: pick_rounds at the frame's
     (16, 2048) with signed zeros, exact ties, interleaved sector ids, an
     empty sector, sectors with fewer valid columns than 6, suppression
     across sector edges with a broken gap chain; odo_corr at K=0 and
     K=16 with duplicates across the kernel's slice edges, an
     all-sentinel slice, rows with no nearby-ring partner and ragged N;
     select_fit rows cases with ties and a seeded pair;
   * select_fit on the planar (3, Q, 8P) pair calls of one real
     pre-initialisation LIO frame (the one-level mapping gather), same
     tolerances;
   * pick_rounds, odo_corr and select_fit on the calls of a 64-ring frame
     (bench.py's MSF_BENCH_RINGS=64 configuration: (64, 2048) planes, edge
     N=768 M=7680, plane N=1536 M=8192; select_fit odometry plane
     (3, 1536, 8), mapping pair line (2048, 768) + plane2 (4096, 768)) and
     the seeded pick cases at (64, 2048);
   * knn at scripts/bench_knn.py's shapes (Q=4096, M=65536, k=8 and k=5,
     10% of the refs masked) and on seeded cases (fewer valid refs than k,
     duplicated refs, ragged Q and M): d2 bit-equal, indices equal;
   per kernel and call site the event time (median of 50 launches around
   the wrapper), the device-only time (torch.profiler kernel time over 50
   launches; a batch of 50 back-to-back launches between one event pair
   beside it), the wrapper's host cost (event minus device-only), the
   plain version's time, for knn the library yardstick (cdist + masked
   fill + topk), the bound max(bytes / 3.35 TB/s, operations / 67
   TFLOP/s), for knn also the instruction-issue bound under -fmad=false
   (9 float instructions a pair over 132 SMs x 128 lanes at the card's
   maximum SM clock from nvidia-smi), and the launch (clusters, blocks,
   threads, shared memory, registers, local bytes and residency from the
   CUDA runtime; the ptxas lines of the build give each instantiation's
   registers, spills and shared memory);
3. the knn path: its entry point ``knn_auto`` at both bench shapes, with
   launches counted around it;
4. the lidar-only main path through ``SlamPipeline(cfg, device="cuda")``:
   accuracy (10 frames of the tests/test_pipeline.py corridor drive, ATE
   < 0.05 m), the first 3 frames again with ``device="cpu"`` (plain
   versions; mapped poses within 1e-3 m / 1e-3), speed over 20 distinct
   frames of the bench.py drive with launches counted (1 pick_rounds + 4
   odo_corr + 4 select_fit per frame: 2 odometry calls and one pair per
   mapping round; one extra pick_rounds on the first frame), host-clock
   stage times over 5 frames and a profile of 3;
5. the LIO path through ``SlamPipeline.add_imu`` + ``process_ring_image``
   on tests/test_lio_pipeline.py's distorted corridor drive (V0 = (1.2,
   0.4, 0) m/s, 0.25 rad/s yaw, 400 Hz IMU, init_frames=6,
   warmup_msgs=10): accuracy over 9 frames with tight_coupling off and on
   (ATE < 0.15 m each); 3 post-init frames again with ``device="cpu"``
   from the card's state (mapped poses within 1e-3 m / 1e-3, velocity
   within 1e-2 m/s); speed over 20 distinct frames at full width (the
   bench.py LIO configuration, tight coupling, ~40-sample IMU windows)
   with launches counted per frame (1 pick_rounds + 4 odo_corr + 4
   select_fit on every post-init frame), host-clock time per LIO stage
   over 5 frames, and a torch.profiler trace of 3 post-init frames.

6. the batched multi-sequence path through ``batch_pipeline.
   init_batch_state`` + ``run_batch`` (B lanes in one set of launches): the
   kernel calls of one real B=8 serving frame at bench.py's
   run_batched_mode configuration (lane b on frames b..b+2 of the bench
   drive; pick_rounds (128, 2048) bit-equal; the lane-axis odo_corr
   bit-equal to its plain version and to one single-lane launch per lane,
   with seeded lanes of different valid counts and an all-sentinel lane;
   select_fit odometry (3, 3072, 8) and the pairs line (8192, 768) +
   plane2 (32768, 768) at the tolerances above), timed as above;
   accuracy on tests/test_batch_pipeline.py's drives (B=2, 5 frames: ATE
   < 0.08 m per lane; 30 frames with eviction: ATE < 0.10 m, fewer than
   9000 surface points); the first 3 frames again with ``device="cpu"``
   (poses within 1e-3); speed at bench.py's run_batched_mode
   configuration with the bench drive's 30 frames tiled to every lane, at
   B=8 and B=1: launches per frame (1 pick_rounds + 4 odo_corr + 4
   select_fit at both), aggregate scans/s, peak memory, the spread of
   poses across lanes, and a profile of 3 frames each (all launches per
   frame at B=8 at most 1.1x those at B=1).

7. pose graph and loop closure (``slam.posegraph``, ``slam.loop_closure``,
   ``slam.scan_context``) with the block-Thomas kernel ``block_tridiag``:
   (a) the segmented kernel bit-equal to its plain version on seeded SPD
   systems at N = 20 and 64 with m = 1 and 49 right-hand sides, on edge
   shapes (N = 1, 2, 3; segments of 2; a ragged last segment; a lone last
   block joined to its neighbour; P = 1 by force; JAX's 8 x 8 segments),
   and on the first Gauss-Newton system with loops of (c) (N = 8192,
   m = 49) under the segment rule (one call of the plain version, timed)
   and at segment lengths 64 and 256; event, device-only and batch times
   at N = 8192, m = 1 and 49, the rule's L and P, the chain depth and the
   time a dependent step, the launch geometry (grid blocks, threads,
   registers, local bytes), the bound, a segment-length sweep, and the
   dense torch.linalg.solve of the assembled 6N x 6N system as the library
   yardstick (median of 3 at N = 1024, one call at N = 8192);
   (b) run_slam's five --selftest shutdown fusions, now through the app
   itself: phase 9(e);
   (c) a graph at KITTI-00 size (4541 poses padded to 8192: a square
   driven twice with a 1e-4 rad yaw bias a pose, GPS every 10th pose with
   U(-5, 5) cm noise, 8 loop factors from ground truth): optimize and
   optimize_with_loops, 10 iterations each (finite poses, falling cost),
   their wall times and errors, host-clock stages and a profile;
   (d) (c)'s problem at N = 64 with ``device="cpu"`` against the card
   (poses within 1e-3).

8. the odometry switches (``odometry.motion_deskew``, the in-matcher
   ``deskew``, ``plane_corr="triangle"``), checkpoint and stage timers:
   (a) the lidar-only frame with ``motion_deskew`` on
   tests/test_lio_pipeline.py's distorted drive (9 frames, ATE < 0.15 m;
   the same drive with the switch off printed beside it; the first frame
   inserts no point), its first 3 frames again with ``device="cpu"``
   (poses within 1e-3), and 20 distinct bench-drive frames at full width
   with launches counted per frame (1 pick_rounds + 4 odo_corr + 4
   select_fit) and ``SlamPipeline.metrics()``'s host-clock stage means;
   (b) tests/test_odometry.py's accelerating scene at full width: the
   in-matcher deskew within 0.02 m of the true step and under 0.6x the
   rigid matcher's error with ``plane_corr`` "fit" and "triangle", 4
   odo_corr + 2 select_fit launches a ``match_scan2scan`` with "fit" and
   2 + 0 with "triangle"; lidar frames with ``deskew`` and the
   three-point plane at full width (1 + 2 + 2 launches a frame);
   (c) the batched frame with ``motion_deskew`` on
   tests/test_batch_pipeline.py's distorted drive (B=2 x 5 frames, ATE
   < 0.1 m a lane, 1 + 4 + 4 launches a frame);
   (d) the pre-initialisation LIO frames with ``motion_deskew`` on
   tests/test_lio_pipeline.py's accelerating drive (initialised, mapped
   position error < 0.08 m on every frame, gravity tilt sin < 0.05);
   (e) a checkpoint on the card: 6 full-width lidar frames with
   ``motion_deskew``, a checkpoint after frame 3 loaded into a fresh
   pipeline, frames 4-6 within 1e-5 m of the uninterrupted run; the file
   loads on ``device="cpu"`` too.

9. ingest and the apps: ``python -m msf_loam_tpu_torch.apps.run_slam``'s
   ``main`` in this process (kernel launches counted around each run; the
   (a) and (b) fixtures are written between phases 1 and 2, their scans
   ray-cast by a pool of host processes that has ended before phase 2):
   (a) a 20-frame KITTI-format sequence at HDL-64E scale (64 rings x 1800
   columns, ~115k points a scan, World.corridor(seed=2, size=15.0), 0.1
   rad/s yaw) with ``--n_rings 64 --eval --sim_gps --posegraph --save_map
   --pbstream``: the native C++ prefetcher on every frame (the native
   runtime must build), 1 pick_rounds + 4 odo_corr + 4 select_fit a frame
   (+1 pick_rounds on frame 0) and posegraph.iterations block_tridiag
   launches, ATE < 0.1 m, the PLY and pbstream read back; once with
   ``--profile_dir`` (the Chrome trace names the four kernels; their device
   time a launch at 64 rings from it) and once without (steady scans/s,
   the prefetcher's wait a scan, metrics() spans, peak memory); 3 frames
   again with ``--device cpu`` (mapped poses within 1e-3 of the card's);
   (b) the NSH-style ROS1 bag of tests/test_nsh_bag.py (230 frames, 16 x
   900 points, 400 Hz IMU, bz2; built by dataio/nsh_bag.py) with ``--bag --loop_closure --eval
   --pbstream``: 230 frames through pre-init and LIO frames (1 + 4 + 4
   launches on every LIO frame), >= 1 loop edge, ATE < 0.12 m, the
   conversion's seconds;
   (c) ``--listen`` on a unix socket fed from a thread by
   ``dataio.stream.stream_bag`` with scripts/stream_producer.py's
   --selftest scene and pacing (55 frames, 30 static, 0.1 m steps, speed
   0.2): processed + dropped = sent, the last 4 steps within 0.08 m of
   ground truth, the final position within 0.3 m; ``--online`` on
   tests/test_bag.py's 5-frame bag (ATE < 0.08 m, drops printed);
   (d) evaluate and export_viz on (a)'s outputs, calib_lidar_imu on the
   card on tests/test_apps.py's 3-axis scene written as a pbstream
   (converged, |q . q_true| > 0.999, q within 1e-5 of a ``--device cpu``
   run; (b)'s planar walk printed, not gated),
   kitti_to_bag on (a)'s sequence, rosbag_to_npz on (b)'s bag;
   (e) the five --selftest shutdown fusions that phase 7(b) drove by
   hand before: the 30-frame out-and-back drive with proximity detection
   + scan matcher (>= 1 loop edge, ATE < 0.08 m, odo_corr, select_fit and
   block_tridiag launched by the loop-closure step), scan context + scan
   matcher and proximity + submap matcher (ATE < 0.08 m), --sim_gps
   --posegraph (ATE < 0.1 m), and the 25-frame straight drive (0 edges,
   ATE < 0.08 m); one block_tridiag launch per Gauss-Newton iteration on
   each.

10. the distribution layer (``msf_loam_tpu_torch/parallel``): a
   ``torch.distributed`` world, collectives counted per frame and per
   Gauss-Newton iteration (``parallel.mesh.COLLECTIVES``):
   (a) world size 1 over NCCL, ``ShardedSlamPipeline`` at full width (the
   lidar configuration above): the 10-frame corridor drive (ATE < 0.05 m),
   poses within 5e-3 of ``SlamPipeline`` on the same association path
   (``reuse_candidates=False``; the cached-candidate frame's distance
   printed), 3 frames again on the CPU over gloo (within 1e-3), 20
   distinct bench frames with scans/s beside both dense frames', launches
   exact (1 pick_rounds + 4 odo_corr + 2 select_fit a frame: the
   mapping's fits are plain PyTorch on the per-round path) and 15
   all-reduces + 2 all-gathers a frame, a profile of 3 frames with the
   collectives' device time;
   (b) world size 2 on the one card: two processes on cuda:0 over gloo
   (NCCL refuses two ranks on one GPU; a check of the logic with the
   kernels on the card, not a speed figure), the drive of (a): ranks
   bit-equal on every pose, within 5e-3 m of (a) and of the dense frame,
   the shards' points (both maps) summing to the dense maps' within 0.5%;
   (c) ``sharded_lio_frame`` at world 1 on phase 5's distorted LIO drive,
   tight coupling, 9 frames: ATE < 0.15 m, 1 + 4 + 2 launches and 15 + 2
   collectives on every post-init frame;
   (d) ``block_tridiag_condense`` and ``block_tridiag_backsub`` (the split
   launches of the distributed solve) bit-equal to their plain versions on
   seeded systems and phase 7(c)'s first GN system, timed;
   ``optimize_with_loops_distributed`` on phase 7(c)'s KITTI-size graph at
   world 1 and world 2 (gloo, as (b)): poses within 1e-3 of
   ``optimize_with_loops``, 3 launches (condense, the separator's
   block_tridiag, back-substitute) and 2 all-gathers + 1 all-reduce a GN
   iteration, wall time;
   (e) ``run_slam --map_shards 1 --eval`` on phase 9(a)'s sequence (ATE <
   0.1 m, 1 + 4 + 2 launches a frame), a sharded checkpoint at world 1
   resumed within 1e-5 m, ``bench_scaling --pipeline`` at world 1.

Prints, before the last line, a ``{"kernels": [...]}`` JSON line (the
launches of pick_rounds, odo_corr, select_fit and block_tridiag are those
of phase 9(a)'s speed run, knn's those of the knn path, the condense and
back-substitute launches those of phase 10(d)'s world-1 run; the batched
frame's call sites as rows of their own) and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Runs only where
``torch.cuda.is_available()``; imports nothing of JAX.
"""

import contextlib
import io
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
REPS = 50
KNN_Q, KNN_M, KNN_KS = 4096, 65536, (8, 5)   # scripts/bench_knn.py
# the lidar and LIO speed runs take 20 frames (30 before the batched path
# joined the run, which keeps it near its earlier length)
LIO_FRAMES, LIO_STAGE_FRAMES, LIO_PROFILE_FRAMES = 20, 5, 3
LIDAR_FRAMES = 20
BATCH_B, BATCH_FRAMES, BATCH_PROFILE_FRAMES = 8, 30, 3
# KITTI-00 size: 4541 poses (padded to the 8192 bucket), 8 loop factors
PG_KITTI_N, PG_LOOPS, PG_REPS = 4541, 8, 10

REPLACES = {
    "pick_rounds": "msf_loam_tpu/ops/pick_rounds.py:138",
    "odo_corr": "msf_loam_tpu/ops/odo_corr.py:152",
    "select_fit": "msf_loam_tpu/ops/select_fit.py:276",
    "knn": "msf_loam_tpu/ops/pallas_knn.py:102",
    "block_tridiag": "msf_loam_tpu/slam/posegraph.py:475 solve_block_tridiag "
                     "(lax.scan; decomposition of "
                     "msf_loam_tpu/parallel/distributed_ba.py)",
    "block_tridiag_condense": "msf_loam_tpu/parallel/distributed_ba.py:30 "
                              "_condense_chain (lax.scan)",
    "block_tridiag_backsub": "msf_loam_tpu/parallel/distributed_ba.py:74 "
                             "_backsub_chain (lax.scan)",
}
DEVICE_KERNEL = {"pick_rounds": "pick_rounds_kernel",
                 "odo_corr": "odo_corr_kernel",
                 "select_fit": "select_fit_kernel", "knn": "knn_",
                 "block_tridiag": "block_tridiag_kernel",
                 "block_tridiag_condense": "block_tridiag_condense_kernel",
                 "block_tridiag_backsub": "block_tridiag_backsub_kernel"}


CARD = "nvidia-smi unavailable"   # name, power limit; set by main()
# block_tridiag's split launches (the distributed solve), counted apart
SPLIT = ("block_tridiag_condense", "block_tridiag_backsub")
SPLIT_ZERO = {k: 0 for k in SPLIT}


def fail(msg):
    raise RuntimeError(msg)


def say(msg):
    """Print a line of results with the card it was measured on."""
    print(f"{msg} [{CARD}]")


def cuda_ms(torch, fn, reps=REPS):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events around
    each call: the wrapper's host work included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def batch_ms(torch, fn, reps=REPS):
    """Milliseconds per call of ``reps`` back-to-back calls between one
    event pair (the device time where the host keeps ahead of it)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def self_dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_events(prof):
    """Device-side events of a trace, each kernel once."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and self_dev_us(e) > 0]


def device_only_ms(torch, fn, key, reps=REPS):
    """Device time per launch of the kernels whose names hold ``key``, from
    a torch.profiler trace of ``reps`` calls (every wrapper call is one
    launch; dividing by the launches the trace holds keeps a dropped event
    from lowering the time); None if the trace has none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in device_events(prof) if key in e.key]
    us, n = sum(self_dev_us(e) for e in mine), sum(e.count for e in mine)
    return us / 1e3 / n if us > 0 and n else None


def kernel_times(torch, name, fn, plain_fn, plain_reps=10):
    """Event ms, device-only ms (profiler, else the batch), batch ms and
    plain ms of one call site."""
    t = dict(ms=cuda_ms(torch, fn), batch_ms=batch_ms(torch, fn),
             plain_ms=cuda_ms(torch, plain_fn, reps=plain_reps))
    dev = device_only_ms(torch, fn, DEVICE_KERNEL[name])
    t["device_ms"] = dev if dev is not None else t["batch_ms"]
    t["device_from"] = "profiler" if dev is not None else "batch"
    return t


def issue_ms(c, pairs, per_pair=9):
    """knn's instruction-issue bound under -fmad=false: ``per_pair`` float
    instructions a pair (3 subtractions, 3 multiplications, 2 additions,
    the compare) over 132 SMs x 128 lanes at the card's maximum SM clock
    (nvidia-smi, this run)."""
    return pairs * per_pair / (132 * 128 * c.sm_clock_mhz * 1e6) * 1e3


def bound_ms(nbytes, nops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class Row:
    """Per-kernel sums over its call sites."""

    def __init__(self):
        self.v = dict(ms=0.0, device_ms=0.0, batch_ms=0.0, plain_ms=0.0,
                      bytes=0.0, ops=0.0, err=0.0)
        self.library_ms = None
        self.device_from = set()

    def add(self, t, nbytes, nops):
        for k in ("ms", "device_ms", "batch_ms", "plain_ms"):
            self.v[k] += t[k]
        self.v["bytes"] += nbytes
        self.v["ops"] += nops
        self.device_from.add(t["device_from"])

    def out(self):
        b, by = bound_ms(self.v["bytes"], self.v["ops"])
        return dict(ms=self.v["ms"], device_ms=self.v["device_ms"],
                    batch_ms=self.v["batch_ms"], plain_ms=self.v["plain_ms"],
                    bound_ms=b, bound_by=by, max_abs_err=self.v["err"],
                    library_ms=self.library_ms,
                    device_from="+".join(sorted(self.device_from)))


def fmt(t):
    return (f"kernel {t['ms']:.4f} ms (events), device {t['device_ms']:.4f} "
            f"ms ({t['device_from']}; batch {t['batch_ms']:.4f}), wrapper "
            f"host cost {t['ms'] - t['device_ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms")


def ptxas_entries(log):
    """(template arguments, registers, spill bytes, shared bytes) of each
    kernel entry in an ``nvcc -Xptxas -v`` log."""
    out = []
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"'([^']+)'", block).group(1)
        targs = ",".join(re.findall(r"Li(\d+)E", name))
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out.append((targs, int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0,
                    int(smem.group(1)) if smem else 0))
    return out


# --------------------------------------------------------------- scenes
def corridor_drive(n):
    """tests/test_pipeline.py: gentle arc through the 12 m corridor."""
    out = []
    for i in range(n):
        yaw = 0.02 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        out.append((np.array([0.25 * i, 0.3 * np.sin(0.1 * i), 0.0]), R))
    return out


def bench_drive(n):
    """bench.py: 1.5 m/s, 0.2 rad/s yaw, 10 Hz, through the 14 m corridor."""
    dt, speed, yaw_rate = 0.1, 1.5, 0.2
    p, yaw, out = np.zeros(3), 0.0, []
    for _ in range(n):
        c, s = np.cos(yaw), np.sin(yaw)
        out.append((p.copy(), np.array([[c, -s, 0.0], [s, c, 0.0],
                                        [0.0, 0.0, 1.0]])))
        p = p + np.array([c, s, 0.0]) * speed * dt
        yaw += yaw_rate * dt
    return out


def images(synthetic, preprocess, fcfg, world, poses, noise, seed_of, device,
           n_rings=16):
    imgs = []
    for i, (t, R) in enumerate(poses):
        xyz, ring = synthetic.simulate_scan(world, t, R, n_rings=n_rings,
                                            pts_per_ring=1800, noise=noise,
                                            seed=seed_of(i))
        imgs.append(preprocess.preprocess_scan(xyz, ring, fcfg,
                                               num_rings=n_rings,
                                               device=device))
    return imgs


# tests/test_lio_pipeline.py: constant world velocity, constant yaw rate,
# motion-distorted scans, analytic 400 Hz IMU
LIO_G = np.array([0.0, 0.0, 9.81])
LIO_V0 = np.array([1.2, 0.4, 0.0])
LIO_YAW_RATE = 0.25
LIO_T0 = 1.0


def lio_pose_at(t):
    c, s = np.cos(LIO_YAW_RATE * t), np.sin(LIO_YAW_RATE * t)
    return LIO_V0 * t, np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def lio_feed_imu(pipe, n_frames):
    t = LIO_T0 - 0.5
    while t < LIO_T0 + n_frames * 0.1 + 0.2:
        _, R = lio_pose_at(t)
        pipe.add_imu(t, R.T @ LIO_G, np.array([0.0, 0.0, LIO_YAW_RATE]))
        t += 1.0 / 400


def lio_images(synthetic, preprocess, fcfg, world, n, device):
    imgs, gt = [], []
    p0, R0 = lio_pose_at(LIO_T0)
    for i in range(n):
        ts = LIO_T0 + 0.1 * i
        p, R = lio_pose_at(ts)
        gt.append(R0.T @ (p - p0))
        xyz, ring = synthetic.simulate_scan(
            world, p, R, n_rings=16, pts_per_ring=1800, noise=0.004, seed=i,
            linear_vel=LIO_V0, yaw_rate=LIO_YAW_RATE)
        imgs.append(preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=16,
                                               device=device))
    return imgs, np.asarray(gt)


# ------------------------------------------------------------ checkers
def check_pick(torch, pr, args, kw, tag):
    got = pr.pick_rounds(*args, **kw)
    want = pr.pick_rounds_plain(*args, **kw)
    for g, w, n in zip(got, want, ("corner", "flat", "suppressed")):
        if not torch.equal(g, w):
            fail(f"pick_rounds {tag}: {n} differs from the plain version "
                 f"({int((g != w).sum())} entries)")
    return 0.0


def check_odo(torch, oc, q, planes, K, nearby, tag):
    got = oc.odo_corr_planes(q, planes, K, nearby)
    want = oc.odo_corr_plain(q, planes, K, nearby)
    for f in ("a_idx", "a_ring", "c_idx", "cand_idx", "cand_ring"):
        if not torch.equal(getattr(got, f), getattr(want, f)):
            fail(f"odo_corr {tag}: {f} differs from the plain version")
    err = 0.0
    for f in ("a_d2", "c_d2", "cand_d2"):
        g, w = getattr(got, f), getattr(want, f)
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            fail(f"odo_corr {tag}: {f} not bit-equal to the plain version "
                 f"({int((g != w).sum())} entries)")
        fin = w < 1e37
        if fin.any():
            err = max(err, float((g - w).abs()[fin].max()))
    return err


def pick_adversarial(torch, rng, R, W, dev):
    """Seeded (score_c, score_f, sector, cb0) planes of the cases the
    sorted walk must get right (tests/test_torch_kernel_algorithms.py)."""
    S = 6
    for name in ("ties", "signed zeros", "interleaved sectors",
                 "empty and thin sectors", "boundary suppression"):
        curv = (rng.integers(0, 6, (R, W)) * 0.25).astype(np.float32)
        sec = np.sort(rng.integers(0, S, (R, W)), axis=1)
        sec[:, :5] = -1
        ok = rng.uniform(size=(R, W)) > 0.2
        cb0 = np.cumsum(rng.uniform(size=(R, W)) > 0.9, axis=1)
        if name == "signed zeros":          # -curv is -0.0; +0.0 planted
            curv[:, ::3] = 0.0
            curv[:, 1::7] = -0.0
        elif name == "interleaved sectors":
            sec = rng.integers(-1, S, (R, W))
        elif name == "empty and thin sectors":
            sec = np.where(sec == 2, 3, sec)
            for r in range(R):
                thin = np.flatnonzero(sec[r] == 4)
                ok[r, thin] = False
                ok[r, thin[:3]] = True
                curv[r, thin[:3]] = 1.0
        elif name == "boundary suppression":
            curv[:] = 1.0
            curv[:, ::2] = 0.0
            ok[:] = True
            cb0 = np.cumsum((np.arange(W) % 7) == 0)[None, :].repeat(R, 0)
        neg = np.float32(-1e18)
        planes = (np.where(ok & (curv > 0.3), curv, neg),
                  np.where(ok & (curv < 0.1), -curv, neg), sec, cb0)
        yield name, tuple(
            torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
            for a, dt in zip(planes, (np.float32, np.float32, np.int32,
                                      np.int32)))


def odo_adversarial(torch, oc, rng, N, M0, K, dev):
    """Seeded (q, planes) with duplicates across the kernel's slice edges,
    an all-sentinel slice, queries on a ring with no nearby partner and a
    ragged query count."""
    xyz = rng.uniform(-8, 8, (M0, 3)).astype(np.float32)
    ring = rng.integers(0, 16, M0).astype(np.int32)
    mask = rng.uniform(size=M0) > 0.1
    M = M0 + (-M0) % (K * 128 if K else 128)
    L16, L8 = M // 16, M // 8
    for cut in (L16, 3 * L8, 5 * L16):
        xyz[cut - 1] = xyz[cut] = xyz[cut + 5]
        ring[cut - 1] = ring[cut] = ring[cut + 5]
        mask[cut - 1] = mask[cut] = mask[cut + 5] = True
    mask[2 * L16:3 * L16] = False
    ring[-40:] = 100
    mask[-40:] = True
    q = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    q[:10] = xyz[-40:-30]
    q[10:20] = xyz[L16 + 5]
    q[20:30] = xyz[3 * L8 + 5]
    t = [torch.from_numpy(a).to(dev) for a in (q, xyz, mask, ring)]
    return t[0], oc.ref_planes(t[1], t[2], t[3], K)


def pick_work(R, W, kw):
    """(bytes, operations) of one pick_rounds call."""
    n_picks = kw["n_sharp"] + -(-kw["n_rest"] // kw["rest_T"]) * kw["rest_T"] \
        + kw["n_flat"]
    return R * W * 16 + R * W + n_picks * R * kw["S"] * 4, R * W * n_picks


def odo_work(N, M, K, B=1):
    """(bytes, operations) of one odo_corr call over B lanes."""
    return B * (N * 12 + M * 16 + N * (5 + 3 * K) * 4), B * N * M * 15


def odo_shape(q, planes):
    """(B, N, M) of an odo_corr call (B = 1 without a lane axis)."""
    return (q.shape[0] if q.dim() == 3 else 1), q.shape[-2], planes.shape[-1]


def pick_site(c, args, kw):
    """Time one pick_rounds call site and print it with its launch."""
    torch, pr = c.torch, c.pr
    R, W = args[0].shape
    t = kernel_times(torch, "pick_rounds", lambda: pr.pick_rounds(*args, **kw),
                     lambda: pr.pick_rounds_plain(*args, **kw))
    b, by = bound_ms(*pick_work(R, W, kw))
    g = pr.launch_geometry(W, kw["S"])
    say(f"  pick_rounds ({R}, {W}): {fmt(t)}, bound {b:.5f} ms ({by}); "
        f"grid {g['cluster']} x {R} blocks in clusters of {g['cluster']}, "
        f"{g['threads']} threads, {g['smem']} B dynamic shared memory")
    return t


def odo_site(c, q, planes, K, nb):
    """Time one odo_corr call site and print it with its launch."""
    torch, oc = c.torch, c.oc
    B, N, M = odo_shape(q, planes)
    t = kernel_times(torch, "odo_corr",
                     lambda: oc.odo_corr_planes(q, planes, K, nb),
                     lambda: oc.odo_corr_plain(q, planes, K, nb))
    b, by = bound_ms(*odo_work(N, M, K, B))
    g = oc.launch_geometry(N, M, K, B)
    say(f"  odo_corr K={K} B={B} N={N} M={M}: {fmt(t)}, bound {b:.5f} ms "
        f"({by}); {g['lanes']} lanes, {g['blocks']} blocks in clusters of "
        f"{g['cluster']}, 256 threads, {g['smem']} B dynamic shared memory")
    return t


def plain_select(sf, cand, q, r2s, r2w, kw):
    C = cand.shape[1] // 3 if cand.dim() == 2 else cand.shape[2]
    if cand.dim() == 2:
        x, y, z = cand[:, :C], cand[:, C:2 * C], cand[:, 2 * C:]
    else:
        x, y, z = cand
    gates = dict(k=kw["k"], mode=kw.get("mode", "plane2"),
                 min_count=kw.get("min_count", 5),
                 min_wide=kw.get("min_wide", 5),
                 eig_ratio=sf._f32(kw.get("eig_ratio", 3.0)),
                 tol=sf._f32(kw.get("tol", 0.2)),
                 cond_frac=sf._f32(kw.get("cond_frac", 0.05)))
    return x, y, z, gates, sf.select_fit_plain(x, y, z, q, sf._f32(r2s),
                                               sf._f32(r2w), **gates)


def gate_margins(torch, sf, x, y, z, q, r2s, r2w, g):
    """Relative distance of every gate value from its threshold, per row
    (plain float32 arithmetic); the smallest over the mode's gates."""
    dx, dy, dz = x - q[:, 0:1], y - q[:, 1:2], z - q[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inf = torch.full((), sf._INF, device=x.device)
    d2s = torch.where(d2 <= sf._f32(r2s), d2, inf)
    cur, v = d2s, None
    for _ in range(g["k"]):
        v = cur.min(dim=1, keepdim=True).values
        cur = torch.where(cur <= v, inf, cur)
    w = ((d2s <= v) & (d2s < sf._INF * 0.5)).float()
    _, mean, s = sf._moments(w, dx, dy, dz)
    e0, e1, e2 = sf._eig3(*s)

    def rel(a, b):
        return (a - b).abs() / (a.abs() + b.abs() + 1e-30)

    if g["mode"] == "line":
        return rel(e0, g["eig_ratio"] * e1)
    n = sf._eigvec(*s, e0, e1)
    maxres = (sf._resid(n, mean, dx, dy, dz) * w).max(dim=1).values
    m = torch.minimum(rel(maxres, torch.full_like(maxres, g["tol"])),
                      rel(e1, g["cond_frac"] * e0))
    if g["mode"] == "plane2":
        ww = (d2 <= sf._f32(r2w)).float()
        _, wm, sw = sf._moments(ww, dx, dy, dz)
        v0, v1, _ = sf._eig3(*sw)
        wn = sf._eigvec(*sw, v0, v1)
        rr = sf._resid(wn, wm, dx, dy, dz)
        tol = torch.full_like(maxres, g["tol"])
        for a in ((rr * ww).max(dim=1).values, (rr * w).max(dim=1).values):
            m = torch.minimum(m, rel(a, tol))
        m = torch.minimum(m, rel(v1, g["cond_frac"] * v0))
    return m


def check_select(torch, sf, cand, q, r2s, r2w, kw, tag, got=None):
    """One select_fit result (``got``, else a fresh kernel call) against
    the plain version on the same inputs."""
    if got is None:
        got = sf.select_fit(cand, q, r2s, r2w, **kw)
    x, y, z, g, want = plain_select(sf, cand, q, r2s, r2w, kw)
    fin = want.d2 < 1e37
    if not torch.equal(got.d2.view(torch.int32), want.d2.view(torch.int32)):
        fail(f"select_fit {tag}: d2 not bit-equal to the plain version "
             f"({int((got.d2 != want.d2).sum())} entries)")
    flips = got.valid != want.valid
    n_flip = int(flips.sum())
    if n_flip:
        m = gate_margins(torch, sf, x, y, z, q, r2s, r2w, g)[flips]
        if float(m.max()) > 1e-5:
            fail(f"select_fit {tag}: {n_flip} validity flips, one with a "
                 f"gate {float(m.max()):.2e} (relative) from its threshold")
    both = got.valid & want.valid
    cerr = float((got.center - want.center).abs()[both].max()) if both.any() else 0.0
    dots = (got.normal * want.normal).sum(dim=1).abs()[both]
    if cerr > 1e-4 or (dots.numel() and float(dots.min()) < 1 - 1e-4):
        fail(f"select_fit {tag}: centre error {cerr}, normal dot "
             f"{float(dots.min()) if dots.numel() else 1.0}")
    nerr = float((1 - dots).max()) if dots.numel() else 0.0
    say(f"  select_fit {tag}: {int(want.valid.sum())}/{q.shape[0]} valid, "
          f"{n_flip} knife-edge flips")
    return max(cerr, nerr, float((got.d2 - want.d2).abs()[fin].max())
               if fin.any() else 0.0)


def select_work(cand, q, kw):
    """(bytes, operations) of one select_fit problem."""
    N = q.shape[0]
    C = cand.numel() // (3 * N) if N else 0
    k = kw["k"]
    return (cand.numel() * 4 + N * 12 + N * (k + 7) * 4,
            N * C * ({"line": 40, "plane": 50, "plane2": 90}[kw["mode"]] + k))


def cand_c(cand):
    return cand.shape[1] // 3 if cand.dim() == 2 else cand.shape[2]


def fmt_sf_geometry(g):
    return (f"{g['blocks']} blocks of {g['threads']} threads, {g['G']} lanes "
            f"a query x {g['P']} candidates a lane, {g['smem']} B shared, "
            f"{g['regs']} registers, {g['local']} B local, {g['per_sm']} "
            f"blocks resident per SM")


def select_site(torch, sf, row, cand, q, r2s, r2w, kw, tag, add=True):
    """Check one select_fit call site, time it and (``add``) add it to
    ``row``."""
    q = q.contiguous()
    row.v["err"] = max(row.v["err"], check_select(torch, sf, cand, q, r2s,
                                                  r2w, kw, tag))
    t = kernel_times(torch, "select_fit",
                     lambda: sf.select_fit(cand, q, r2s, r2w, **kw),
                     lambda: plain_select(sf, cand, q, r2s, r2w, kw))
    nbytes, nops = select_work(cand, q, kw)
    b, by = bound_ms(nbytes, nops)
    g = sf.launch_geometry(q.shape[0], cand_c(cand))
    say(f"  select_fit {kw['mode']} {tuple(cand.shape)}: {fmt(t)}, bound "
          f"{b:.5f} ms ({by}); {fmt_sf_geometry(g)}")
    if add:
        row.add(t, nbytes, nops)
    return t


def pair_site(torch, sf, row, a, tag):
    """One mapping round's pair launch ``a`` = (cand_a, query_a, r2s_a,
    r2w_a, kw_a, cand_b, ...): each half against its plain call, checked
    and timed alone, then the pair launch checked against the two plain
    calls, timed and added to ``row``."""
    halves = (a[:5], a[5:])
    for (cand, q, r2s, r2w, kw), h in zip(halves, "ab"):
        select_site(torch, sf, row, cand, q, r2s, r2w, kw, f"{tag} {h} "
                    f"{kw['mode']} alone", add=False)
    got = sf.select_fit_pair(*a)
    for g, (cand, q, r2s, r2w, kw), h in zip(got, halves, "ab"):
        row.v["err"] = max(row.v["err"], check_select(
            torch, sf, cand, q, r2s, r2w, kw, f"{tag} pair {h}", got=g))
    t = kernel_times(torch, "select_fit", lambda: sf.select_fit_pair(*a),
                     lambda: [plain_select(sf, c_, q_, s_, w_, k_)
                              for c_, q_, s_, w_, k_ in halves])
    work = [select_work(h[0], h[1], h[4]) for h in halves]
    nbytes, nops = sum(w[0] for w in work), sum(w[1] for w in work)
    b, by = bound_ms(nbytes, nops)
    g = sf.launch_geometry(a[1].shape[0], cand_c(a[0]), a[6].shape[0],
                           cand_c(a[5]))
    say(f"  select_fit pair {a[4]['mode']} {tuple(a[0].shape)} + "
        f"{a[9]['mode']} {tuple(a[5].shape)} ({tag}): {fmt(t)}, bound "
        f"{b:.5f} ms ({by}); {fmt_sf_geometry(g)}")
    row.add(t, nbytes, nops)
    return t


def check_knn(torch, kn, q, r, m, k, tag):
    d, i = kn.knn_pallas(q, r, m, k=k)
    pd, pi = kn.knn_plain(q, r, m, k)
    if not torch.equal(d, pd):
        fail(f"knn {tag}: d2 not bit-equal to the plain version "
             f"({int((d != pd).sum())} entries)")
    if not torch.equal(i, pi):
        fail(f"knn {tag}: indices differ from the plain version "
             f"({int((i != pi).sum())} entries)")
    empty = i < 0
    if not bool((d[empty] == 3e38).all()) or \
            not bool(m[i[~empty].long()].all()) or \
            not bool((d[:, 1:] >= d[:, :-1]).all()):
        fail(f"knn {tag}: sentinel, mask or order contract broken")
    say(f"  knn {tag}: Q={q.shape[0]} M={r.shape[0]} k={k} bit-equal, "
          f"{int(empty.sum())} empty slots")
    return 0.0


def knn_library(torch, q, r, m, k):
    """The yardstick (library calls, not one): cdist without the matrix
    product formula, masked columns to 3e38, topk."""
    d = torch.cdist(q, r, compute_mode="donot_use_mm_for_euclid_dist")
    d.masked_fill_(~m[None, :], 3e38)
    return torch.topk(d, k, dim=1, largest=False)


# ----------------------------------------------------------- phases
def staged_patches(torch, stage_s, patches):
    """Wrap module functions so each outermost call is timed on the host
    clock between two synchronisations (nested calls count once, in the
    outer stage)."""
    active = []

    def staged(name, fn):
        def wrapped(*a, **kw):
            if active:
                return fn(*a, **kw)
            active.append(name)
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                active.pop()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapped

    saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
    for m, a, name in patches:
        setattr(m, a, staged(name, getattr(m, a)))
    return saved


def timed(label, run):
    """run() with its wall time printed."""
    t0 = time.perf_counter()
    out = run()
    say(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def restore(saved):
    for m, a, fn in saved:
        setattr(m, a, fn)


def profile_frames(torch, run, label):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = device_events(prof)
    dev_us = sum(self_dev_us(e) for e in evs)
    if dev_us <= 0:
        say(f"profile {label}: no device time in the trace (not measured)")
        return None
    n_launch = sum(e.count for e in evs)
    say(f"profile {label}: {wall * 1e3:.1f} ms wall (traced), device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
          f"{n_launch} kernel launches")
    for e in sorted(evs, key=lambda e: -self_dev_us(e))[:15]:
        say(f"  {self_dev_us(e) / 1e3:8.3f} ms {e.count:5d}x {e.key[:90]}")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    say("  host time by op (self CPU): " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.1f} ms / {e.count}x"
        for e in host[:12]))
    for name, key in DEVICE_KERNEL.items():
        mine = [e for e in evs if key in e.key]
        if mine:
            say(f"  hand-written {name}: {sum(self_dev_us(e) for e in mine) / 1e3:.3f}"
                  f" ms over {sum(e.count for e in mine)} launches")
    return dict(launches=n_launch, busy=dev_us / 1e6 / wall, wall=wall)


def record_calls(c, patches, run):
    """Run ``run()`` with each (module, attribute, wrapper) of ``patches``
    recording its calls; returns each attribute's calls as (cloned args,
    kwargs)."""
    torch = c.torch
    calls = {attr: [] for _, attr, _ in patches}

    def recorder(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((tuple(t.clone() if torch.is_tensor(t) else t
                                      for t in a), dict(kw)))
            return fn(*a, **kw)
        return wrapped

    for mod, attr, fn in patches:
        setattr(mod, attr, recorder(attr, fn))
    try:
        run()
    finally:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    return calls


def frame_patches(c):
    """The kernel wrappers as a frame's modules call them."""
    return [(c.features, "pick_rounds", c.pr.pick_rounds),
            (c.odometry, "odo_corr", c.oc.odo_corr),
            (c.odometry, "select_fit", c.sf.select_fit),
            (c.mapping, "select_fit_pair", c.sf.select_fit_pair)]


def capture_frame(c, cfg, n_rings):
    """The kernel calls of the third frame of the bench drive through the
    lidar-only pipeline."""
    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(3), 0.004, lambda i: 100 + i, c.dev,
                  n_rings=n_rings)
    pipe = c.SlamPipeline(cfg, device="cuda")
    for img in imgs[:2]:
        pipe.process_ring_image(img, 0.0)
    return record_calls(c, frame_patches(c),
                        lambda: pipe.process_ring_image(imgs[2], 0.2))


def lidar_kernel_phase(c, rows):
    """Capture one real lidar-only frame's kernel calls and hold each kernel
    to its plain version (plus seeded tie / sentinel cases)."""
    torch, pr, oc, sf = c.torch, c.pr, c.oc, c.sf
    calls = capture_frame(c, c.cfg, 16)
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"pick_rounds": 1, "odo_corr": 4, "select_fit": 2,
                  "select_fit_pair": 2}:
        fail(f"captured calls per frame {counts}")
    rng = np.random.default_rng(0)
    dev = c.dev

    # pick_rounds: the frame's planes + seeded adversarial cases
    row = rows["pick_rounds"] = Row()
    (args, kw), = calls["pick_rounds"]
    check_pick(torch, pr, args, kw, "frame")
    R, W = args[0].shape
    for name, planes in pick_adversarial(torch, rng, R, W, dev):
        check_pick(torch, pr, planes, kw, f"seeded {name}")
    t = pick_site(c, args, kw)
    row.add(t, *pick_work(R, W, kw))

    # odo_corr: the frame's 4 calls (2 rounds x edge, plane) + seeded cases
    row = rows["odo_corr"] = Row()
    for i, (a, kw) in enumerate(calls["odo_corr"]):
        q = a[0].float().contiguous()
        planes = oc.ref_planes(a[1], a[2], a[3], kw["K"])
        K, nb = kw["K"], kw["nearby"]
        row.v["err"] = max(row.v["err"], check_odo(torch, oc, q, planes, K,
                                                   nb, f"call {i}"))
        t = odo_site(c, q, planes, K, nb)
        row.add(t, *odo_work(*odo_shape(q, planes)[1:], K))
    for K, N, M0 in ((0, 192, 1900), (16, 384, 8000), (16, 77, 2000),
                     (0, 33, 300)):
        qs, ps = odo_adversarial(torch, oc, rng, N, M0, K, dev)
        check_odo(torch, oc, qs, ps, K, 2.5, f"seeded K={K} N={N}")
        got = oc.odo_corr_planes(qs, ps, K, 2.5)
        M = ps.shape[1]
        if not bool((got.c_idx[:10] == M).all()) or \
                not bool((got.a_idx[10:20] == M // 16 - 1).all()):
            fail(f"odo_corr seeded K={K}: no-partner or tie rows wrong")
    say(f"  odo_corr and pick_rounds seeded cases: bit-equal (duplicates "
        f"across slice edges, an all-sentinel slice, no-partner rows, "
        f"ragged N; signed zeros, ties, interleaved / empty / thin "
        f"sectors, suppression across sector edges)")

    # select_fit: the frame's 2 odometry calls and 2 mapping pairs (one
    # launch per call) + seeded rows cases with ties and a seeded pair
    row = rows["select_fit"] = Row()
    for i, (a, kw) in enumerate(calls["select_fit"]):
        cand, q, r2s, r2w = a
        select_site(torch, sf, row, cand, q, r2s, r2w, kw,
                    f"odometry call {i} {kw.get('mode')}")
    for i, (a, _) in enumerate(calls["select_fit_pair"]):
        pair_site(torch, sf, row, a, f"mapping round {i}")
    N, C = 1024, 256
    qn = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    off = rng.uniform(-1.5, 1.5, (N, C, 3)).astype(np.float32)
    off[:, 128:160] = off[:, 0:32]                      # duplicate distances
    off[:, :, 2] *= 0.02                                # near-planar
    cnd = qn[:, None, :] + off
    cnd[rng.uniform(size=(N, C)) < 0.2] = 1e9           # empty-slab sentinel
    cnd = np.transpose(cnd, (0, 2, 1)).reshape(N, 3 * C)
    cnd_t = torch.from_numpy(np.ascontiguousarray(cnd)).to(dev)
    qn_t = torch.from_numpy(qn).to(dev)
    for mode in ("line", "plane2"):
        row.v["err"] = max(row.v["err"], check_select(
            torch, sf, cnd_t, qn_t, 1.0, 4.0,
            dict(k=5, mode=mode, min_count=5, min_wide=5), f"seeded {mode}"))
    # a seeded pair: rows line (1024) + planar plane2 (777 rows, ragged)
    planar = cnd_t[:777].view(777, 3, C).permute(1, 0, 2).contiguous()
    kw_a = dict(k=5, mode="line", min_count=5)
    kw_b = dict(k=5, mode="plane2", min_count=5, min_wide=5)
    got = sf.select_fit_pair(cnd_t, qn_t, 1.0, 4.0, kw_a, planar,
                             qn_t[:777].contiguous(), 0.5, 2.0, kw_b)
    for g, args, h in zip(got, ((cnd_t, qn_t, 1.0, 4.0, kw_a),
                                (planar, qn_t[:777].contiguous(), 0.5, 2.0,
                                 kw_b)), "ab"):
        row.v["err"] = max(row.v["err"], check_select(
            torch, sf, *args, f"seeded pair {h}", got=g))


def ring64_phase(c):
    """pick_rounds, odo_corr and select_fit at the 64-ring shapes (bench.py's
    MSF_BENCH_RINGS=64 configuration): the calls of the third frame of the
    bench drive at 64 rings, held to the plain versions (pick_rounds and
    odo_corr bit-equal, select_fit to its tolerances) and timed, and the
    seeded pick cases at (64, 2048)."""
    torch, pr, oc, sf = c.torch, c.pr, c.oc, c.sf
    cfg = c.MsfLoamConfig(
        features=c.cfg.features,
        mapping=c.MappingConfig(map_table_size=1 << 15, map_cell_capacity=32,
                                max_query_points=4096,
                                max_corner_query_points=2048))
    calls = capture_frame(c, cfg, 64)
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"pick_rounds": 1, "odo_corr": 4, "select_fit": 2,
                  "select_fit_pair": 2}:
        fail(f"64-ring frame: captured calls {counts}")
    say("64-ring shapes (bench.py MSF_BENCH_RINGS=64 configuration):")
    (args, kw), = calls["pick_rounds"]
    check_pick(torch, pr, args, kw, "64-ring frame")
    R, W = args[0].shape
    for name, planes in pick_adversarial(torch, np.random.default_rng(2), R,
                                         W, c.dev):
        check_pick(torch, pr, planes, kw, f"64-ring seeded {name}")
    pick_site(c, args, kw)
    for i, (a, kw) in enumerate(calls["odo_corr"][:2]):  # edge, plane
        q = a[0].float().contiguous()
        K, nb = kw["K"], kw["nearby"]
        planes = oc.ref_planes(a[1], a[2], a[3], K)
        check_odo(torch, oc, q, planes, K, nb, f"64-ring call {i}")
        odo_site(c, q, planes, K, nb)
    sub = Row()
    for i, (a, kw) in enumerate(calls["select_fit"]):
        select_site(torch, sf, sub, *a, kw, f"64-ring odometry call {i}")
    for i, (a, _) in enumerate(calls["select_fit_pair"]):
        pair_site(torch, sf, sub, a, f"64-ring mapping round {i}")
    o = sub.out()
    say(f"  select_fit per 64-ring frame (2 odometry calls, 2 pairs): device "
        f"{o['device_ms']:.4f} ms, event {o['ms']:.4f} ms, bound "
        f"{o['bound_ms']:.5f} ms ({o['bound_by']})")
    return sub.v["err"]


def knn_phase(c, rows):
    """knn on the card against its plain version, then its path."""
    torch, kn, dev = c.torch, c.kn, c.dev
    rng = np.random.default_rng(1)
    row = rows["knn"] = Row()
    q = torch.from_numpy(rng.uniform(-20, 20, (KNN_Q, 3))
                         .astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.uniform(-20, 20, (KNN_M, 3))
                         .astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.uniform(size=KNN_M) >= 0.1).to(dev)
    lib = 0.0
    for k in KNN_KS:
        check_knn(torch, kn, q, r, m, k, f"bench k={k}")
        t = kernel_times(torch, "knn", lambda: kn.knn_pallas(q, r, m, k=k),
                         lambda: kn.knn_plain(q, r, m, k))
        t_lib = cuda_ms(torch, lambda: knn_library(torch, q, r, m, k), reps=5)
        lib += t_lib
        ld, li = knn_library(torch, q, r, m, k)
        kd, _ = kn.knn_pallas(q, r, m, k=k)
        yard = float(((ld * ld - kd).abs() / kd.clamp(min=1e-6)).max())
        nbytes = KNN_Q * 12 + KNN_M * 13 + KNN_Q * k * 8
        nops = KNN_Q * KNN_M * 8
        b, by = bound_ms(nbytes, nops)
        g = kn.launch_geometry(KNN_Q, k)
        say(f"  knn Q={KNN_Q} M={KNN_M} k={k}: {fmt(t)}, library (cdist + "
              f"masked fill + topk) {t_lib:.4f} ms (its d^2 within {yard:.1e} "
              f"relative), bound {b:.5f} ms ({by}); instruction-issue bound "
              f"{issue_ms(c, KNN_Q * KNN_M):.5f} ms; {g['blocks']} blocks in "
              f"clusters of {g['cluster']}, {g['threads']} threads, "
              f"{g['R']} queries a thread, lists of {g['list']}, "
              f"{g['smem']} B shared, {g['regs']} registers, {g['local']} B "
              f"local, {g['clusters']} clusters resident at once")
        row.add(t, nbytes, nops)
    row.library_ms = lib
    # seeded cases: fewer valid refs than k, duplicates (exact ties),
    # Q and M multiples of no block size
    Q, M = 1001, 3001
    qs = rng.uniform(-3, 3, (Q, 3)).astype(np.float32)
    rs = rng.uniform(-3, 3, (M, 3)).astype(np.float32)
    rs[2000:3000] = rs[0:1000]
    qs[:100] = rs[:100]
    ms = rng.uniform(size=M) >= 0.1
    args = [torch.from_numpy(a).to(dev) for a in (qs, rs, ms)]
    check_knn(torch, kn, *args, 8, "seeded duplicates, ragged")
    few = np.zeros(M, bool)
    few[[7, 2500, 2999]] = True
    check_knn(torch, kn, args[0], args[1], torch.from_numpy(few).to(dev), 5,
              "seeded 3 valid refs")

    # the path: its entry point at both bench shapes, launches counted
    c.kernels.reset_launch_counts()
    for k in KNN_KS:
        d, i = kn.knn_auto(q, r, m, k=k)
        if d.shape != (KNN_Q, k) or not bool(torch.isfinite(d).all()):
            fail(f"knn_auto k={k}: bad output")
    torch.cuda.synchronize()
    launches = dict(c.kernels.LAUNCHES)
    want = {name: 0 for name in launches}
    want["knn"] = len(KNN_KS)
    if launches != want:
        fail(f"knn path launches {launches}, expected {want}")
    say(f"knn path (knn_auto, k={KNN_KS}): launches {launches}")
    return launches["knn"]


def lidar_path_phase(c):
    """Accuracy, CPU parity, speed, stages and profile of the lidar-only
    frame; returns its speed run's launch counts."""
    torch, kernels = c.torch, c.kernels
    acc_world = c.synthetic.World.corridor(seed=0, size=12.0)
    drive = corridor_drive(10)
    acc_imgs = images(c.synthetic, c.preprocess, c.cfg.features, acc_world,
                      drive, 0.005, lambda i: 3, c.dev)
    pipe = c.SlamPipeline(c.cfg, device="cuda")
    for i, img in enumerate(acc_imgs):
        pipe.process_ring_image(img, 0.1 * i)
    traj = pipe.trajectory()
    gt = np.asarray([t for t, _ in drive])
    ate = c.ate_rmse(traj[:, 1:4], gt, align=False)
    say(f"lidar accuracy: ATE {ate:.5f} m over {len(drive)} frames "
          f"(bound 0.05 m)")
    if not np.isfinite(traj).all() or ate >= 0.05:
        fail(f"ATE {ate} m")

    cpu = c.SlamPipeline(c.cfg, device="cpu")
    worst = 0.0
    for i, img in enumerate(acc_imgs[:3]):
        r = cpu.process_ring_image(img.to("cpu"), 0.1 * i)
        dt = float(np.abs(r.map_pose.t.numpy() - traj[i, 1:4]).max())
        dq = float(np.abs(r.map_pose.q.numpy() - traj[i, 4:8]).max())
        worst = max(worst, dt, dq)
    say(f"lidar cpu plain versions vs card, 3 frames: max |dpose| "
          f"{worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"CPU and card mapped poses differ by {worst}")

    n_frames, warm = LIDAR_FRAMES, 5
    bench_imgs = images(c.synthetic, c.preprocess, c.cfg.features,
                        c.bench_world, bench_drive(n_frames), 0.004,
                        lambda i: 100 + i, c.dev)
    pipe = c.SlamPipeline(c.cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stamps = []
    t_run = time.perf_counter()
    for i, img in enumerate(bench_imgs):
        pipe.process_ring_image(img, 0.1 * i)    # returns host floats: synced
        stamps.append(time.perf_counter())
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    steady = (n_frames - warm) / (stamps[-1] - stamps[warm - 1])
    want = {"pick_rounds": n_frames + 1, "odo_corr": 4 * n_frames,
            "select_fit": 4 * n_frames, "knn": 0, "block_tridiag": 0, **SPLIT_ZERO}
    say(f"lidar speed: {steady:.2f} scans/s steady state (frames {warm}-"
          f"{n_frames - 1}), first frame {stamps[0] - t_run:.3f} s;"
          f" peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    if launches != want:
        fail(f"lidar launch counts {launches}, expected {want}")
    pos = pipe.trajectory()[:, 1:4]
    gt = np.asarray([t for t, _ in bench_drive(n_frames)])
    say(f"bench drive: final position error "
          f"{float(np.linalg.norm(pos[-1] - gt[-1])):.4f} m after "
          f"{float(np.linalg.norm(gt[-1] - gt[0])):.2f} m")
    if not np.isfinite(pos).all():
        fail("non-finite poses on the bench drive")

    stage_s = {}
    saved = staged_patches(torch, stage_s, [
        (c.features, "extract_features", "extract_features"),
        (c.odometry, "match_scan2scan", "match_scan2scan"),
        (c.pipe_mod, "downsample_features_grouped", "downsample"),
        (c.mapping, "match_scan2map_core", "match_scan2map_core"),
        (c.vm, "insert", "insert")])
    try:
        t0 = time.perf_counter()
        for i, img in enumerate(bench_imgs[5:10]):
            pipe.process_ring_image(img, 4.0 + 0.1 * i)
        frame_s = (time.perf_counter() - t0) / 5
    finally:
        restore(saved)
    say(f"lidar stages (ms per frame, synchronised, {frame_s * 1e3:.1f} ms "
          f"frame): " + ", ".join(f"{k} {v * 1e3 / 5:.2f}"
                                  for k, v in stage_s.items()))

    def run3():
        for i, img in enumerate(bench_imgs[:3]):
            pipe.process_ring_image(img, 3.0 + 0.1 * i)
    profile_frames(torch, run3, "lidar, 3 frames")
    return launches


def lio_select_capture_phase(c, row):
    """The planar (3, Q, 8P) select_fit pair calls of one real pre-init LIO
    frame at full width, held to the plain version."""
    torch, sf = c.torch, c.sf
    imgs, _ = lio_images(c.synthetic, c.preprocess, c.lio_cfg.features,
                         c.lio_world, 3, c.dev)
    pipe = c.SlamPipeline(c.lio_cfg, device="cuda")
    lio_feed_imu(pipe, 3)
    for i in range(2):
        pipe.process_ring_image(imgs[i], LIO_T0 + 0.1 * i)
    calls = []

    def rec(*a, **kw):
        calls.append((tuple(t.clone() if torch.is_tensor(t) else t
                            for t in a), dict(kw)))
        return sf.select_fit_pair(*a, **kw)

    c.mapping.select_fit_pair = rec
    try:
        pipe.process_ring_image(imgs[2], LIO_T0 + 0.2)
    finally:
        c.mapping.select_fit_pair = sf.select_fit_pair
    torch.cuda.synchronize()
    if len(calls) != 2 or any(a[0].dim() != 3 or a[5].dim() != 3
                              for a, _ in calls):
        fail(f"pre-init LIO frame: {len(calls)} mapping select_fit pairs, "
             f"shapes {[tuple(a[0].shape) for a, _ in calls]}")
    sub = Row()
    for i, (a, _) in enumerate(calls):
        pair_site(torch, sf, sub, a, f"lio pre-init mapping round {i}")
    row.v["err"] = max(row.v["err"], sub.v["err"])
    o = sub.out()
    say(f"  select_fit planar mapping pairs per pre-init frame: event "
          f"{o['ms']:.4f} ms, device {o['device_ms']:.4f} ms, plain "
          f"{o['plain_ms']:.3f} ms, bound {o['bound_ms']:.5f} ms "
          f"({o['bound_by']})")


def lio_accuracy_phase(c):
    """9 frames of the distorted corridor drive with tight coupling off and
    on; then 3 post-init frames again on the CPU from the card's state."""
    torch = c.torch
    from msf_loam_tpu_torch import interop
    fcfg = c.FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    n = 9
    imgs, gt = lio_images(c.synthetic, c.preprocess, fcfg, c.lio_world, n,
                          c.dev)
    for tight in (False, True):
        cfg = c.MsfLoamConfig(
            features=fcfg,
            mapping=c.MappingConfig(map_table_size=1 << 13,
                                    max_query_points=2048),
            imu=c.ImuConfig(init_frames=6, warmup_msgs=10, max_imu_samples=64,
                            tight_coupling=tight))
        pipe = c.SlamPipeline(cfg, device="cuda")
        lio_feed_imu(pipe, n)
        snap, vels = None, []
        for i, img in enumerate(imgs):
            if i == 6:
                snap = c.SlamPipeline(cfg, device="cpu")
                interop.load_pipeline_state(snap, pipe)
            pipe.process_ring_image(img, LIO_T0 + 0.1 * i)
            vels.append(pipe.velocity.cpu().numpy())
        traj = pipe.trajectory()
        ate = c.ate_rmse(traj[:, 1:4], gt, align=False)
        say(f"lio accuracy (tight_coupling={tight}): ATE {ate:.5f} m over "
              f"{n} frames (bound 0.15 m); initialised {pipe.is_initialized},"
              f" gravity {np.round(pipe.gravity.cpu().numpy(), 4).tolist()},"
              f" velocity {np.round(vels[-1], 4).tolist()}")
        if not np.isfinite(traj).all() or ate >= 0.15 or \
                not pipe.is_initialized:
            fail(f"LIO ATE {ate} m (tight_coupling={tight})")
    # CPU plain versions from the card's state before frame 6 (tight)
    worst_p, worst_v = 0.0, 0.0
    for i in range(6, n):
        r = snap.process_ring_image(imgs[i].to("cpu"), LIO_T0 + 0.1 * i)
        worst_p = max(worst_p,
                      float(np.abs(r.map_pose.t.numpy() - traj[i, 1:4]).max()),
                      float(np.abs(r.map_pose.q.numpy() - traj[i, 4:8]).max()))
        worst_v = max(worst_v, float(np.abs(snap.velocity.numpy()
                                            - vels[i]).max()))
    say(f"lio cpu plain versions vs card, post-init frames 6-8: max |dpose| "
          f"{worst_p:.2e} (tolerance 1e-3), max |dv| {worst_v:.2e} m/s "
          f"(tolerance 1e-2)")
    if worst_p > 1e-3 or worst_v > 1e-2:
        fail(f"LIO CPU and card differ: pose {worst_p}, velocity {worst_v}")


def lio_speed_phase(c):
    """20 distinct frames at full width (tight coupling), launches per
    frame, stage times, profile. Returns the run's launch counts."""
    torch, kernels = c.torch, c.kernels
    n = LIO_FRAMES
    total = n + LIO_STAGE_FRAMES + LIO_PROFILE_FRAMES
    imgs, gt = lio_images(c.synthetic, c.preprocess, c.lio_cfg.features,
                          c.lio_world, total, c.dev)
    pipe = c.SlamPipeline(c.lio_cfg, device="cuda")
    lio_feed_imu(pipe, total)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stamps, per_frame, init_at = [], [], None
    t_run = time.perf_counter()
    for i in range(n):
        before = dict(kernels.LAUNCHES)
        pipe.process_ring_image(imgs[i], LIO_T0 + 0.1 * i)  # synced
        stamps.append(time.perf_counter())
        per_frame.append({k: kernels.LAUNCHES[k] - before[k]
                          for k in before})
        if init_at is None and pipe.is_initialized:
            init_at = i
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if init_at is None:
        fail("LIO speed run never initialised")
    first = init_at + 1                       # first post-init (fused) frame
    want = {"pick_rounds": 1, "odo_corr": 4, "select_fit": 4, "knn": 0,
            "block_tridiag": 0, **SPLIT_ZERO}
    bad = [i for i in range(first, n) if per_frame[i] != want]
    if bad:
        fail(f"LIO post-init frames {bad} launched {per_frame[bad[0]]}, "
             f"expected {want} per frame")
    if any(per_frame[i]["pick_rounds"] != 1 for i in range(n)):
        fail("a LIO frame did not launch pick_rounds once")
    dts = np.diff([t_run] + stamps)
    ic = c.lio_cfg.imu
    refine = [i for i in range(n) if (i + 1) >= 2 * ic.init_frames
              and (i + 1) % ic.grav_refine_period == 0]
    steady = (n - first - 1) / (stamps[-1] - stamps[first])
    pos = pipe.trajectory()[:, 1:4]
    err = float(np.linalg.norm(pos[-1] - gt[n - 1]))
    say(f"lio speed: {steady:.2f} scans/s steady state (post-init frames "
          f"{first + 1}-{n - 1}; median frame {np.median(dts[first + 1:]) * 1e3:.1f}"
          f" ms), first post-init frame {dts[first]:.3f} s, initialised "
          f"after frame {init_at}; peak device memory {peak / 2**20:.1f} "
          f"MiB; launches {launches}; per post-init frame {want}; "
          f"pre-init frames {[per_frame[i] for i in (0, 1)]}; gravity "
          f"refine + bias solve frames "
          f"{ {i: round(float(dts[i]) * 1e3, 1) for i in refine} } ms; "
          f"final position error {err:.4f} m")
    if not np.isfinite(pos).all() or err > 0.5:
        fail(f"LIO speed drive lost track: final error {err} m")

    stage_s = {}
    saved = staged_patches(torch, stage_s, [
        (c.features, "extract_features", "extract"),
        (c.odometry, "match_scan2scan", "odometry"),
        (c.preint_mod, "preintegrate", "preintegrate"),
        (c.imu_factor_mod, "imu_presolve", "presolve"),
        (c.pipe_mod, "downsample_features_grouped", "downsample"),
        (c.mapping, "match_scan2map_tight_core", "scan-to-map"),
        (c.deskew_mod, "undistort_full", "deskew+insert"),
        (c.vm, "insert", "deskew+insert"),
        (pipe, "_estimator_add", "estimator")])
    try:
        t0 = time.perf_counter()
        for i in range(n, n + LIO_STAGE_FRAMES):
            pipe.process_ring_image(imgs[i], LIO_T0 + 0.1 * i)
        frame_s = (time.perf_counter() - t0) / LIO_STAGE_FRAMES
    finally:
        restore(saved)
    k = LIO_STAGE_FRAMES
    say(f"lio stages (ms per post-init frame, each synchronised, "
          f"{frame_s * 1e3:.1f} ms frame, {k} frames): "
          + ", ".join(f"{s} {v * 1e3 / k:.2f}" for s, v in stage_s.items())
          + f", other {(frame_s - sum(stage_s.values()) / k) * 1e3:.2f}")

    def run3():
        for i in range(n + k, total):
            pipe.process_ring_image(imgs[i], LIO_T0 + 0.1 * i)
    profile_frames(torch, run3, f"lio, {LIO_PROFILE_FRAMES} post-init frames")
    return launches


# ------------------------------------------------------- batched pipeline
def batch_cfg(c, B):
    """bench.py run_batched_mode: per-lane tables of (1 << 15) // B slots
    (the fused table holds the single stream's 32k), no eviction."""
    return c.MsfLoamConfig(
        features=c.cfg.features,
        mapping=c.MappingConfig(map_table_size=(1 << 15) // B,
                                map_cell_capacity=32, max_query_points=4096,
                                max_corner_query_points=1024,
                                map_evict_period=0))


def stack_frames(c, frames):
    """frames[t][b] RingImages -> one RingImage with leaves (T, B, ...)."""
    return c.RingImage(*(
        c.torch.stack([c.torch.stack([getattr(im, f) for im in lanes])
                       for lanes in frames]) for f in c.RingImage._fields))


def check_odo_lanes(torch, oc, q, planes, K, nearby, tag):
    """A lane-axis odo_corr launch against the plain version with the same
    lane axis and against one single-lane launch per lane, bit for bit."""
    err = check_odo(torch, oc, q, planes, K, nearby, tag)
    got = oc.odo_corr_planes(q, planes, K, nearby)
    for b in range(q.shape[0]):
        one = oc.odo_corr_planes(q[b].contiguous(), planes[b].contiguous(),
                                 K, nearby)
        for f in one._fields:
            g, w = getattr(got, f)[b], getattr(one, f)
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                fail(f"odo_corr {tag}: lane {b} {f} differs from its "
                     f"single-lane launch")
    return err


def odo_lanes_adversarial(torch, oc, rng, N, M0, K, dev):
    """Four seeded lanes: two adversarial clouds (odo_adversarial), one
    with its last two thirds masked (fewer valid points), one all
    sentinels."""
    qs, ps = zip(*(odo_adversarial(torch, oc, rng, N, M0, K, dev)
                   for _ in range(4)))
    q, planes = torch.stack(qs).contiguous(), torch.stack(ps).contiguous()
    M = planes.shape[-1]
    planes[1, :3, M // 3:] = 1e9
    planes[1, 3, M // 3:] = 1e6
    planes[2, :3] = 1e9
    planes[2, 3] = 1e6
    return q, planes


def batch_kernel_phase(c, rows):
    """One real B=8 serving frame of the batched pipeline (lane b on frames
    b..b+2 of the bench drive, so every lane holds other data): its
    pick_rounds, odo_corr and select_fit calls held to the plain versions,
    odo_corr also to one single-lane launch per lane, plus seeded lanes."""
    torch, pr, oc, sf, bp = c.torch, c.pr, c.oc, c.sf, c.bp
    B = BATCH_B
    cfg = batch_cfg(c, B)
    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(B + 2), 0.004, lambda i: 100 + i, c.dev)
    seq = stack_frames(c, [[imgs[b + t] for b in range(B)]
                           for t in range(3)])
    state = bp.init_batch_state(cfg, B, 16)
    state, _ = bp.run_batch(cfg, state, c.RingImage(*(a[:2] for a in seq)))
    calls = record_calls(c, frame_patches(c), lambda: bp._frame_fn(
        cfg, cfg.mapping.map_table_size, state,
        c.RingImage(*(a[2] for a in seq)), False))
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"pick_rounds": 1, "odo_corr": 4, "select_fit": 2,
                  "select_fit_pair": 2}:
        fail(f"batched frame: captured calls {counts}")
    say(f"batched serving frame (B={B}, bench.py run_batched_mode "
        f"configuration):")
    rng = np.random.default_rng(4)

    row = rows["pick_rounds"] = Row()
    (args, kw), = calls["pick_rounds"]
    R, W = args[0].shape
    if (R, W) != (16 * B, 2048):
        fail(f"batched pick_rounds planes {(R, W)}")
    check_pick(torch, pr, args, kw, f"batched frame B={B}")
    row.add(pick_site(c, args, kw), *pick_work(R, W, kw))

    row = rows["odo_corr"] = Row()
    for i, (a, kw) in enumerate(calls["odo_corr"]):
        q = a[0].float().contiguous()
        K, nb = kw["K"], kw["nearby"]
        planes = oc.ref_planes(a[1], a[2], a[3], K)
        if q.dim() != 3 or q.shape[0] != B:
            fail(f"batched odo_corr call {i}: queries {tuple(q.shape)}")
        row.v["err"] = max(row.v["err"], check_odo_lanes(
            torch, oc, q, planes, K, nb, f"batched call {i}"))
        row.add(odo_site(c, q, planes, K, nb), *odo_work(
            *odo_shape(q, planes)[1:], K, B))
    for K, N, M0 in ((0, 192, 1900), (16, 384, 8000)):
        q, planes = odo_lanes_adversarial(torch, oc, rng, N, M0, K, c.dev)
        check_odo_lanes(torch, oc, q, planes, K, 2.5,
                        f"seeded lanes K={K}")
        got = oc.odo_corr_planes(q, planes, K, 2.5)
        if not bool((got.c_idx[2] == planes.shape[-1]).all()) or \
                not bool((got.a_d2[2] > 1e17).all()):
            fail(f"odo_corr seeded lanes K={K}: the all-sentinel lane")
    say("  odo_corr lane axis: every lane bit-equal to the plain version "
        "and to its single-lane launch (frame calls; seeded lanes with "
        "different valid counts and an all-sentinel lane)")

    row = rows["select_fit"] = Row()
    for i, (a, kw) in enumerate(calls["select_fit"]):
        select_site(torch, sf, row, *a, kw, f"batched odometry call {i}")
    for i, (a, _) in enumerate(calls["select_fit_pair"]):
        pair_site(torch, sf, row, a, f"batched mapping round {i}")


def batch_drive_images(c, B, T, step_of, fcfg, device, distort=False):
    """tests/test_batch_pipeline.py: lane b in World.corridor(seed=b),
    straight steps ``step_of(b)`` a frame (``distort``: each sweep captured
    while moving at that speed); (T, B) images and (B, T, 3) ground
    truth."""
    frames = [[None] * B for _ in range(T)]
    gts = np.zeros((B, T, 3))
    for b in range(B):
        world = c.synthetic.World.corridor(seed=b, size=12.0)
        for i in range(T):
            t = step_of(b) * i
            kw = dict(linear_vel=step_of(b) / 0.1) if distort else {}
            xyz, ring = c.synthetic.simulate_scan(
                world, t, np.eye(3), n_rings=16, pts_per_ring=900,
                noise=0.004, seed=10 * b + i, **kw)
            frames[i][b] = c.preprocess.preprocess_scan(
                xyz, ring, fcfg, num_rings=16, device=device)
            gts[b, i] = t
    return stack_frames(c, frames), gts


def batch_speed(c, B, bench_imgs):
    """The bench drive's frames tiled to B lanes at bench.py's
    run_batched_mode configuration: launches per frame, aggregate scans/s
    (frames 5 to T-4; the last 3 frames run under the profiler), peak
    memory and the spread of poses across lanes."""
    torch, kernels, bp = c.torch, c.kernels, c.bp
    cfg = batch_cfg(c, B)
    T, P = len(bench_imgs), BATCH_PROFILE_FRAMES
    seq = stack_frames(c, [[img] * B for img in bench_imgs])
    part = [c.RingImage(*(a[i:j] for a in seq))
            for i, j in ((0, 5), (5, T - P), (T - P, T))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, p0 = bp.run_batch(cfg, bp.init_batch_state(cfg, B, 16), part[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, p1 = bp.run_batch(cfg, state, part[1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = {}

    def last():
        out["state"], out["poses"] = bp.run_batch(cfg, state, part[2])
    prof = profile_frames(torch, last, f"batched B={B}, {P} frames")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # init_batch_state extracts the empty previous scan: one pick_rounds
    want = {"pick_rounds": T + 1, "odo_corr": 4 * T, "select_fit": 4 * T,
            "knn": 0, "block_tridiag": 0, **SPLIT_ZERO}
    if launches != want:
        fail(f"batched B={B}: launches {launches}, expected {want} (1 "
             f"pick_rounds + 4 odo_corr + 4 select_fit a frame, one "
             f"pick_rounds in init_batch_state)")
    pos = torch.cat([p0.t, p1.t, out["poses"].t]).cpu().numpy()  # (T, B, 3)
    spread = float(np.abs(pos - pos[:, :1]).max())
    gt = np.asarray([t for t, _ in bench_drive(T)])
    err = float(np.linalg.norm(pos[-1] - gt[-1], axis=-1).max())
    n_mid = T - P - 5
    steady = n_mid * B / (t2 - t1)
    say(f"batched speed B={B}: {steady:.2f} scans/s aggregate steady state "
        f"(frames 5-{T - P - 1}, {steady / B:.2f} per lane, "
        f"{(t2 - t1) / n_mid * 1e3:.1f} ms a frame); first 5 frames with "
        f"the initial state {(t1 - t0) * 1e3:.1f} ms; peak device memory "
        f"{peak / 2**20:.1f} MiB; launches {launches} ({T} frames); pose "
        f"spread across lanes {spread:.2e} m; final position error "
        f"{err:.4f} m")
    if not np.isfinite(pos).all() or err > 0.5:
        fail(f"batched B={B} lost track: final error {err} m")
    return dict(launches=launches, steady=steady, profile=prof)


def batch_path_phase(c):
    """Accuracy, eviction, CPU parity and speed of the batched pipeline;
    returns the B=8 speed run's launch counts."""
    torch, bp = c.torch, c.bp
    fcfg = c.FeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    cfg = c.MsfLoamConfig(features=fcfg, mapping=c.MappingConfig(
        map_table_size=1 << 12, map_cell_capacity=16, max_query_points=1024))
    seq, gts = batch_drive_images(
        c, 2, 5, lambda b: np.array([0.25, 0.05 * (b + 1), 0.0]), fcfg,
        c.dev)
    state, poses = bp.run_batch(cfg, bp.init_batch_state(cfg, 2, 16), seq)
    est = poses.t.cpu().numpy()
    ates = [c.ate_rmse(est[:, b], gts[b], align=False) for b in range(2)]
    say(f"batched accuracy (B=2, 5 frames, tests/test_batch_pipeline.py): "
        f"ATE per lane {[round(a, 5) for a in ates]} m (bound 0.08 m)")
    if not np.isfinite(est).all() or max(ates) >= 0.08:
        fail(f"batched ATE {ates}")

    cpu_state = bp.init_batch_state(cfg, 2, 16, device="cpu")
    _, cpu_poses = bp.run_batch(cfg, cpu_state, c.RingImage(
        *(a[:3].cpu() for a in seq)))
    worst = max(float((cpu_poses.t - poses.t[:3].cpu()).abs().max()),
                float((cpu_poses.q - poses.q[:3].cpu()).abs().max()))
    say(f"batched cpu plain versions vs card, 3 frames x 2 lanes: max "
        f"|dpose| {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"batched CPU and card poses differ by {worst}")

    ecfg = c.MsfLoamConfig(features=fcfg, mapping=c.MappingConfig(
        map_table_size=1 << 12, map_cell_capacity=32, max_query_points=1024,
        map_evict_period=8, map_evict_radius=8.0))
    seq, gts = batch_drive_images(
        c, 2, 30, lambda b: np.array([0.3, 0.03 * (b + 1), 0.0]), fcfg, c.dev)
    state, poses = bp.run_batch(ecfg, bp.init_batch_state(ecfg, 2, 16), seq)
    est = poses.t.cpu().numpy()
    ates = [c.ate_rmse(est[:, b], gts[b], align=False) for b in range(2)]
    total = int(state.surf_map.count.sum())
    say(f"batched eviction drive (B=2, 30 frames, 4096-slot lanes, period "
        f"8, radius 8 m): ATE per lane {[round(a, 5) for a in ates]} m "
        f"(bound 0.10 m), {total} surface points (bound 9000)")
    if not np.isfinite(est).all() or max(ates) >= 0.10 or total >= 9000:
        fail(f"batched eviction drive: ATE {ates}, {total} points")

    bench_imgs = images(c.synthetic, c.preprocess, c.cfg.features,
                        c.bench_world, bench_drive(BATCH_FRAMES), 0.004,
                        lambda i: 100 + i, c.dev)
    runs = {B: batch_speed(c, B, bench_imgs) for B in (BATCH_B, 1)}
    p8, p1 = runs[BATCH_B]["profile"], runs[1]["profile"]
    if p8 and p1:
        ratio = p8["launches"] / p1["launches"]
        say(f"batched launches per frame (all kernels, profiled): B="
            f"{BATCH_B} {p8['launches'] / BATCH_PROFILE_FRAMES:.0f}, B=1 "
            f"{p1['launches'] / BATCH_PROFILE_FRAMES:.0f} (ratio "
            f"{ratio:.3f}, bound 1.1)")
        if ratio > 1.1:
            fail(f"batched launches grow with the lanes: ratio {ratio}")
    say(f"batched aggregate: B={BATCH_B} {runs[BATCH_B]['steady']:.2f} "
        f"scans/s, B=1 {runs[1]['steady']:.2f} scans/s")
    return runs[BATCH_B]["launches"]


# --------------------------------------------- 7. pose graph, loop closure
def pg_problem(c, n, n_loops, device, bias=1e-4, seed=0):
    """A square driven twice (lap 2 retraces lap 1) with a compounding yaw
    bias of ``bias`` rad a pose in the odometry (tests/test_loop_closure.py
    builds its loop problem so), GPS every 10th pose with U(-5, 5) cm noise,
    ``n_loops`` loop factors tying lap-1 poses to their lap-2 twins from
    ground truth; padded to the next size class. Returns (gt_t (n, 3)
    numpy, poses0, data, loops) on ``device``."""
    torch, Pose, pg = c.torch, c.Pose, c.pg
    lap = n // 2
    side = max(1, lap // 4)
    head = np.array([((i % lap) // side % 4) * (np.pi / 2) for i in range(n)])
    gt_t = np.concatenate([np.zeros((1, 3)), np.cumsum(np.stack(
        [np.cos(head[1:]), np.sin(head[1:]), 0 * head[1:]], 1), 0)])

    def yaw_q(y):
        return np.stack([np.cos(y / 2), 0 * y, 0 * y, np.sin(y / 2)], -1)
    dyaw = np.diff(head) + bias
    step = np.diff(gt_t, axis=0)
    cy, sy = np.cos(head[:-1]), np.sin(head[:-1])
    rel_t = np.stack([cy * step[:, 0] + sy * step[:, 1],
                      -sy * step[:, 0] + cy * step[:, 1], 0 * cy], 1)
    yaws = np.concatenate([[0.0], np.cumsum(dyaw)])
    t0 = [np.zeros(3)]
    for i in range(n - 1):
        cw, sw = np.cos(yaws[i]), np.sin(yaws[i])
        t0.append(t0[-1] + np.array([cw * rel_t[i, 0] - sw * rel_t[i, 1],
                                     sw * rel_t[i, 0] + cw * rel_t[i, 1], 0]))
    rng = np.random.default_rng(seed)
    gi = np.arange(0, n, 10)
    gxyz = gt_t[gi] + rng.uniform(-0.05, 0.05, (len(gi), 3))
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    poses0 = Pose(T(np.stack(t0)), T(yaw_q(yaws)))
    data = pg.build_graph_data(T(np.arange(n)), poses0, T(gi), T(gxyz),
                               torch.ones(len(gi), dtype=torch.bool,
                                          device=device))
    data = data._replace(rel_meas=Pose(T(rel_t), T(yaw_q(dyaw))))
    ri = np.linspace(1, lap - 2, n_loops).astype(np.int64)
    rj = ri + lap
    gt = Pose(T(gt_t), T(yaw_q(head)))
    meas = Pose(gt.t[ri], gt.q[ri]).inverse().compose(
        Pose(gt.t[rj], gt.q[rj]))
    loops = pg.LoopFactors.pad(ri, rj, meas, to_l=n_loops)
    poses0, data = pg.pad_graph(poses0, data, pg.next_bucket(n))
    return gt_t, poses0, data, loops


def first_gn_system(c, poses, data, loops, cfg):
    """D, U and [rhs | W] of the first Gauss-Newton step of
    ``optimize_with_loops``, as it hands them to the kernel."""
    pg = c.pg
    _, rel_lin, _, gps_lin = pg._make_factor_fns(cfg)
    D, U, b = pg._assemble_chain(poses, data, cfg, rel_lin, gps_lin)
    b, W = pg._assemble_loops(poses, loops, cfg, b, rel_lin)
    return D, U, c.torch.cat([-b[..., None], W], -1)


def tridiag_work(bt, N, m):
    """(bytes, float operations) of one segmented solve: D, U and B read
    once and X written once; per interior block the condensation step (the
    6x6 factorisation, 12 + m solved columns, the 6 x (12 + m) and
    6 x (6 + m) updates) and m back-substituted columns; per separator
    block the block-Thomas forward step and m backward columns."""
    L, P = bt.segments(N)
    nbytes = 4 * (36 * N + 36 * (N - 1) + 2 * 6 * m * N)
    factor = sum((5 - k) + 2 * (5 - k) ** 2 for k in range(6))
    solve_col = 2 * 15 + 6 + 2 * 15
    interior = max(N - 2 * P, 0)
    nsep = 1 if N == 1 else 2 * P
    ops = (interior * (factor + (12 + m) * solve_col + 12 * 6 * (12 + m)
                       + 12 * 6 * (6 + m) + m * (2 * 12 * 6 + solve_col))
           + nsep * (factor + 6 * solve_col + 12 * 6 * (6 + m)
                     + m * (12 * 6 + solve_col)))
    return nbytes, ops


def dense_from_blocks(torch, D, U):
    """The assembled 6N x 6N matrix tridiag(Uᵀ, D, U) on the card."""
    N = D.shape[0]
    H = torch.zeros((N, 6, N, 6), dtype=D.dtype, device=D.device)
    i = torch.arange(N, device=D.device)
    H[i, :, i, :] = D
    H[i[:-1], :, i[1:], :] = U
    H[i[1:], :, i[:-1], :] = U.transpose(1, 2)
    return H.reshape(6 * N, 6 * N)


def seeded_tridiag(torch, rng, N, m, dev):
    D = rng.normal(size=(N, 6, 6))
    D = np.einsum("nij,nkj->nik", D, D) + 6 * np.eye(6)
    U = rng.normal(size=(N - 1, 6, 6)) * 0.3
    B = rng.normal(size=(N, 6, m))
    T = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return T(D), T(U), T(B)


def check_tridiag(torch, bt, D, U, B, tag, seg_len=None):
    """The plain version's solution, after holding the kernel to it."""
    want = bt.block_tridiag_plain(D, U, B, seg_len)
    torch.cuda.synchronize()
    got = bt.block_tridiag(D, U, B, seg_len)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"block_tridiag {tag}: non-finite solution")
    if not torch.equal(got, want):
        fail(f"block_tridiag {tag}: differs from its plain version by "
             f"{float((got - want).abs().max())}")
    return want


def posegraph_kernel_phase(c, row, system):
    """block_tridiag against its plain version (bit-equal) on seeded SPD
    systems, edge shapes and forced segment lengths, and on the KITTI-size
    graph's first GN system with loops; its times, segments, chain depth,
    launch geometry, bound, the dense-solve yardstick and a segment-length
    sweep."""
    torch, bt = c.torch, c.bt
    rng = np.random.default_rng(0)
    for N in (20, 64):
        for m in (1, 49):
            D, U, B = seeded_tridiag(torch, rng, N, m, c.dev)
            X = check_tridiag(torch, bt, D, U, B, f"N={N} m={m}")
            H = dense_from_blocks(torch, D.double(), U.double())
            res = (H @ X.double().reshape(6 * N, m)
                   - B.double().reshape(6 * N, m)).abs().max()
            say(f"block_tridiag N={N} m={m}: bit-equal to plain; max "
                f"|H x - b| {float(res):.2e} (float64 residual); segments "
                f"{bt.segments(N)}")
    # edge shapes and forced segments: N = 1, 2, 3 (one segment), segments
    # of 2 (no interior), ragged (5 x 4 + 3), a lone last block joined to
    # its neighbour (4 + 5), P = 1 by force, JAX's 8 x 8 and 13-block ones
    edge = [(1, 1, None), (2, 49, None), (3, 1, None), (8, 3, 2),
            (23, 4, 5), (9, 4, 4), (30, 49, 30), (64, 9, 8), (64, 49, 13)]
    for N, m, seg_len in edge:
        D, U, B = seeded_tridiag(torch, rng, N, m, c.dev)
        check_tridiag(torch, bt, D, U, B, f"N={N} m={m} seg_len={seg_len}",
                      seg_len)
    say(f"block_tridiag edge shapes (N, m, seg_len) {edge}: bit-equal to "
        f"plain")
    D, U, B = system
    N, m = B.shape[0], B.shape[2]
    L, P = bt.segments(N)
    depth = bt.chain_depth(N, L, P)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check_tridiag(torch, bt, D, U, B, f"KITTI-size first GN system N={N} "
                  f"m={m}")
    plain_ms = (time.perf_counter() - t0) * 1e3    # one plain call
    for seg_len in (64, 256):
        check_tridiag(torch, bt, D, U, B, f"KITTI-size first GN system "
                      f"seg_len={seg_len}", seg_len)
    say(f"block_tridiag KITTI-size first GN system with loops (N={N}, "
        f"m={m}): bit-equal to its plain version under the rule (L={L}, "
        f"P={P}) and at seg_len 64 and 256")
    for mm in (1, m):
        Bm = B[..., :mm].contiguous()
        fn = lambda: bt.block_tridiag(D, U, Bm)
        t = dict(ms=cuda_ms(torch, fn, reps=PG_REPS),
                 batch_ms=batch_ms(torch, fn, reps=PG_REPS),
                 plain_ms=plain_ms)
        dev_ms = device_only_ms(torch, fn, DEVICE_KERNEL["block_tridiag"],
                                reps=PG_REPS)
        t["device_ms"] = dev_ms if dev_ms is not None else t["batch_ms"]
        t["device_from"] = "profiler" if dev_ms is not None else "batch"
        nbytes, nops = tridiag_work(bt, N, mm)
        b, by = bound_ms(nbytes, nops)
        say(f"block_tridiag N={N} m={mm}: kernel {t['ms']:.4f} ms (events), "
            f"device {t['device_ms']:.4f} ms ({t['device_from']}; batch "
            f"{t['batch_ms']:.4f}); L={L}, P={P}, chain depth {depth} "
            f"dependent 6x6 steps, {t['device_ms'] / depth * 1e3:.3f} us a "
            f"step; bound {b * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{nops / 1e6:.1f} Mflop); launch "
            f"{bt.launch_geometry(N, mm)}")
        if mm == m:
            row.add(t, nbytes, nops)
    say(f"block_tridiag plain version, one call at N={N} m={m}: "
        f"{plain_ms:.1f} ms")
    sweep = []
    for seg_len in (64, 96, 128, 181, 256):
        Ls, Ps = bt.segments(N, seg_len)
        ms = batch_ms(torch, lambda: bt.block_tridiag(D, U, B, seg_len),
                      reps=PG_REPS)
        sweep.append(f"L={Ls} P={Ps} depth {bt.chain_depth(N, Ls, Ps)}: "
                     f"{ms:.4f} ms")
    say(f"block_tridiag segment-length sweep, N={N} m={m} (batch of "
        f"{PG_REPS}): " + "; ".join(sweep))
    lib = {}
    for n_lib, reps in ((min(1024, N), 3), (N, 1)):
        Dl, Ul, Bl = D[:n_lib], U[:n_lib - 1], B[:n_lib]
        H = dense_from_blocks(torch, Dl, Ul)
        rhs = Bl.reshape(6 * n_lib, m)
        ts = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            torch.linalg.solve(H, rhs)
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        lib[n_lib] = float(np.median(ts))
        say(f"library yardstick: dense torch.linalg.solve of the assembled "
            f"{6 * n_lib} x {6 * n_lib} system with {m} right-hand sides "
            f"({H.numel() * 4 / 1e9:.2f} GB): {lib[n_lib]:.1f} ms (median "
            f"of {reps})")
        del H
        torch.cuda.empty_cache()
    row.library_ms = lib[N]


def kitti_graph_phase(c, prob):
    """Phase 7(c): optimize and optimize_with_loops at KITTI-00 size."""
    torch, pg = c.torch, c.pg
    gt_t, poses0, data, loops = prob
    n = len(gt_t)
    cfg = c.sim_cfg.posegraph

    def errs(poses):
        t = poses.t[:n].cpu().numpy()
        return (float(np.linalg.norm(t[-1] - gt_t[-1])),
                float(np.linalg.norm(t - gt_t, axis=1).mean()))
    d0, e0 = errs(poses0)
    say(f"KITTI-size graph: {n} poses padded to {poses0.t.shape[0]}, "
        f"{int(data.gps_valid.sum())} GPS fixes, {loops.idx_i.shape[0]} loop "
        f"factors; before: end-pose drift {d0:.3f} m, mean position error "
        f"{e0:.3f} m")
    for name, run in (("optimize", lambda: pg.optimize(poses0, data, cfg,
                                                       n_iters=10)),
                      ("optimize_with_loops", lambda: pg.optimize_with_loops(
                          poses0, data, loops, cfg, n_iters=10))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d1, e1 = errs(out.poses)
        ic, fc = float(out.initial_cost), float(out.final_cost)
        say(f"KITTI-size {name}, 10 iterations: {wall * 1e3:.1f} ms wall; "
            f"cost {ic:.6g} -> {fc:.6g}; end-pose drift {d1:.3f} m, mean "
            f"position error {e1:.3f} m (not gated)")
        if not (torch.isfinite(out.poses.t).all() and
                torch.isfinite(out.poses.q).all()) or not fc < ic:
            fail(f"KITTI-size {name}: finite poses and a falling cost "
                 f"expected ({ic} -> {fc})")

    stage_s = {}
    saved = staged_patches(torch, stage_s, [
        (pg, "_chain_cost", "cost"), (pg, "_loop_terms", "cost"),
        (pg, "_assemble_chain", "assembly"),
        (pg, "_assemble_loops", "assembly"),
        (pg, "solve_block_tridiag_multi", "solve"),
        (pg, "_capacitance_correction", "capacitance"),
        (c.Pose, "retract", "retract")])
    try:
        t0 = time.perf_counter()
        pg.optimize_with_loops(poses0, data, loops, cfg, n_iters=10)
        wall = time.perf_counter() - t0
    finally:
        restore(saved)
    say(f"KITTI-size optimize_with_loops stages (host clock, synchronised, "
        f"ms over 10 iterations of a {wall * 1e3:.1f} ms run): " + ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in stage_s.items()))
    prof = profile_frames(torch, lambda: pg.optimize_with_loops(
        poses0, data, loops, cfg, n_iters=10),
        "KITTI-size optimize_with_loops, 10 iterations")
    if prof:
        say(f"KITTI-size optimize_with_loops: {prof['launches'] / 10:.0f} "
            f"launches per GN iteration, device busy {100 * prof['busy']:.1f}%")


def pg_parity_phase(c):
    """Phase 7(d): the plain versions on the CPU against the card on the
    KITTI-size problem cut to N=64."""
    pg, cfg = c.pg, c.sim_cfg.posegraph
    worst = 0.0
    outs = {}
    for key, dev in (("cpu", "cpu"), ("card", c.dev)):
        _, poses0, data, loops = pg_problem(c, 64, 8, dev)
        outs[key] = (pg.optimize(poses0, data, cfg, n_iters=10),
                     pg.optimize_with_loops(poses0, data, loops, cfg,
                                            n_iters=10))
    for a, b in zip(outs["cpu"], outs["card"]):
        worst = max(worst, float((a.poses.t - b.poses.t.cpu()).abs().max()),
                    float((a.poses.q - b.poses.q.cpu()).abs().max()))
    say(f"pose graph cpu plain versions vs card, N=64, optimize and "
        f"optimize_with_loops: max |dpose| {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"pose graph CPU and card poses differ by {worst}")


def posegraph_phase(c, row):
    """Phase 7: the pose graph's kernel, a KITTI-size graph and CPU parity
    (run_slam's shutdown fusions run through the app in phase 9(e))."""
    prob = pg_problem(c, PG_KITTI_N, PG_LOOPS, c.dev)
    system = first_gn_system(c, *prob[1:], c.sim_cfg.posegraph)
    timed("pose graph: block_tridiag",
          lambda: posegraph_kernel_phase(c, row, system))
    del system
    timed("pose graph: KITTI-size graph", lambda: kitti_graph_phase(c, prob))
    timed("pose graph: CPU parity", lambda: pg_parity_phase(c))

# ---------------------------------------------- 8. the odometry switches
def switched(cfg, **odometry):
    """``cfg`` with odometry switches set."""
    import dataclasses
    return dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, **odometry))


def frame_launches(c, run):
    """Kernel launches of ``run()`` (counts set to 0 just before it)."""
    c.kernels.reset_launch_counts()
    run()
    c.torch.cuda.synchronize()
    return {k: v for k, v in c.kernels.LAUNCHES.items() if v}


def lidar_switch_phase(c):
    """(a) The lidar-only frame with motion_deskew: accuracy on the
    distorted drive, first-frame insert skip, CPU parity, speed with
    launches per frame and metrics()' stage means."""
    fcfg = c.FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    base = c.MsfLoamConfig(features=fcfg, mapping=c.MappingConfig(
        map_table_size=1 << 13, max_query_points=2048))
    n = 9
    imgs, gt = lio_images(c.synthetic, c.preprocess, fcfg, c.lio_world, n,
                          c.dev)
    ates, trajs = {}, {}
    for on in (True, False):
        pipe = c.SlamPipeline(switched(base, motion_deskew=on),
                              device="cuda")
        for i, img in enumerate(imgs):
            pipe.process_ring_image(img, LIO_T0 + 0.1 * i)
            if i == 0 and on:
                first = int(pipe.corner_map.count.sum()
                            + pipe.surf_map.count.sum())
        trajs[on] = pipe.trajectory()
        ates[on] = c.ate_rmse(trajs[on][:, 1:4], gt, align=False)
    say(f"switches (a) lidar motion_deskew on the distorted drive: ATE "
        f"{ates[True]:.5f} m over {n} frames (bound 0.15 m; switch off "
        f"{ates[False]:.5f} m); points inserted by frame 0: {first}")
    if not np.isfinite(trajs[True]).all() or ates[True] >= 0.15 or first:
        fail(f"motion_deskew lidar drive: ATE {ates[True]}, frame 0 "
             f"inserted {first} points")

    cpu = c.SlamPipeline(switched(base, motion_deskew=True), device="cpu")
    worst = 0.0
    for i, img in enumerate(imgs[:3]):
        r = cpu.process_ring_image(img.to("cpu"), LIO_T0 + 0.1 * i)
        worst = max(worst,
                    float(np.abs(r.map_pose.t.numpy()
                                 - trajs[True][i, 1:4]).max()),
                    float(np.abs(r.map_pose.q.numpy()
                                 - trajs[True][i, 4:8]).max()))
    say(f"switches (a) motion_deskew cpu plain versions vs card, 3 frames: "
        f"max |dpose| {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"motion_deskew CPU and card poses differ by {worst}")

    n_frames, warm = LIDAR_FRAMES, 5
    bench_imgs = images(c.synthetic, c.preprocess, c.cfg.features,
                        c.bench_world, bench_drive(n_frames), 0.004,
                        lambda i: 100 + i, c.dev)
    pipe = c.SlamPipeline(switched(c.cfg, motion_deskew=True),
                          device="cuda")
    per_frame, stamps = [], []
    c.torch.cuda.synchronize()
    t_run = time.perf_counter()
    for i, img in enumerate(bench_imgs):
        per_frame.append(frame_launches(
            c, lambda: pipe.process_ring_image(img, 0.1 * i)))
        stamps.append(time.perf_counter())
    steady = (n_frames - warm) / (stamps[-1] - stamps[warm - 1])
    want = {"pick_rounds": 1, "odo_corr": 4, "select_fit": 4}
    bad = [i for i, got in enumerate(per_frame)
           if got != dict(want, pick_rounds=2 if i == 0 else 1)]
    m = pipe.metrics()
    st = m["stages"]["SLAM/fused-frame"]
    say(f"switches (a) motion_deskew speed: {steady:.2f} scans/s steady "
        f"state (frames {warm}-{n_frames - 1}; first frame "
        f"{stamps[0] - t_run:.3f} s), launches per frame {per_frame[1]} "
        f"(frame 0 {per_frame[0]}); metrics(): SLAM/fused-frame mean "
        f"{st['mean_ms']:.2f} ms over {st['count']} frames (host clock), "
        f"{m['map_points']} map points, {m['map_slots_used']} corner slots")
    if bad:
        fail(f"motion_deskew launches per frame differ on frames {bad}: "
             f"{[per_frame[i] for i in bad]}")
    return per_frame


def odometry_switch_phase(c):
    """(b) The in-matcher deskew with both plane constructions on the
    accelerating scene; launches a match; frames with deskew and the
    three-point plane."""
    fcfg = c.FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    world = c.synthetic.World.corridor(seed=0, size=12.0)
    v0, v1 = np.array([3.0, 0.0, 0.0]), np.array([4.0, 0.0, 0.0])
    step = (v0 + v1) / 2 * 0.1

    def scan(t, v, seed):
        xyz, ring = c.synthetic.simulate_scan(
            world, t, np.eye(3), n_rings=16, pts_per_ring=1800, noise=0.004,
            seed=seed, linear_vel=v, yaw_rate=0.0)
        img = c.preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=16,
                                           device=c.dev)
        return c.features.extract_features(
            img, c.torch.zeros((), device=c.dev), fcfg)

    f0, f1 = scan(np.zeros(3), v0, 1), scan(step, v1, 2)
    warm = c.Pose(c.torch.tensor(v0 * 0.1, dtype=c.torch.float32,
                                 device=c.dev),
                  c.torch.tensor([1.0, 0.0, 0.0, 0.0], device=c.dev))
    want = {"fit": {"odo_corr": 4, "select_fit": 2},
            "triangle": {"odo_corr": 2}}
    for plane_corr in ("fit", "triangle"):
        ocfg = c.OdometryConfig(plane_corr=plane_corr)
        rigid = c.odometry.match_scan2scan(f0, f1, warm, ocfg)
        dcfg = c.OdometryConfig(plane_corr=plane_corr, deskew=True)
        box = {}
        got = frame_launches(c, lambda: box.setdefault(
            "out", c.odometry.match_scan2scan(f0, f1, warm, dcfg)))
        dsk = box["out"]
        e_r = float(np.linalg.norm(rigid.pose_curr2last.t.cpu().numpy()
                                   - step))
        e_d = float(np.linalg.norm(dsk.pose_curr2last.t.cpu().numpy()
                                   - step))
        say(f"switches (b) in-matcher deskew, plane_corr={plane_corr!r}: "
            f"step error {e_d:.5f} m (bound 0.02 m), rigid {e_r:.5f} m "
            f"(ratio {e_d / e_r:.3f}, bound 0.6); launches a match {got}")
        if not bool(dsk.ok) or e_d >= 0.02 or e_d >= 0.6 * e_r:
            fail(f"in-matcher deskew ({plane_corr}): {e_d} m vs rigid {e_r}")
        if got != want[plane_corr]:
            fail(f"match_scan2scan ({plane_corr}, deskew) launched {got}, "
                 f"expected {want[plane_corr]}")

    cfg = switched(c.cfg, deskew=True, plane_corr="triangle")
    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(4), 0.004, lambda i: 100 + i, c.dev)
    pipe = c.SlamPipeline(cfg, device="cuda")
    per_frame = [frame_launches(c, lambda: pipe.process_ring_image(
        img, 0.1 * i)) for i, img in enumerate(imgs)]
    pos = pipe.trajectory()[:, 1:4]
    gt = np.asarray([t for t, _ in bench_drive(4)])
    err = float(np.abs(pos - gt).max())
    say(f"switches (b) lidar frames with deskew + plane_corr='triangle' "
        f"(full width): launches per frame {per_frame[1:]} (frame 0 "
        f"{per_frame[0]}); largest position error {err:.4f} m over 4 frames")
    one = {"pick_rounds": 1, "odo_corr": 2, "select_fit": 2}
    if per_frame[0] != dict(one, pick_rounds=2) or \
            any(p != one for p in per_frame[1:]) or not np.isfinite(pos).all():
        fail(f"deskew + triangle frames launched {per_frame}")
    return per_frame


def batch_switch_phase(c):
    """(c) The batched frame with motion_deskew on the distorted drive."""
    fcfg = c.FeatureConfig(max_points_per_ring=1024, max_less_flat=4096)
    cfg = c.MsfLoamConfig(
        features=fcfg, odometry=c.OdometryConfig(motion_deskew=True),
        mapping=c.MappingConfig(map_table_size=1 << 12, map_cell_capacity=16,
                                max_query_points=1024))
    T = 5
    seq, gts = batch_drive_images(
        c, 2, T, lambda b: np.array([0.25, 0.05 * (b + 1), 0.0]), fcfg,
        c.dev, distort=True)
    state = c.bp.init_batch_state(cfg, 2, 16)
    per_frame, poses = [], []
    for t in range(T):
        box = {}
        per_frame.append(frame_launches(c, lambda: box.setdefault(
            "out", c.bp.run_batch(cfg, state, c.RingImage(
                *(a[t:t + 1] for a in seq))))))
        state, p = box["out"]
        poses.append(p.t[0])
    est = c.torch.stack(poses).cpu().numpy()
    ates = [c.ate_rmse(est[:, b], gts[b], align=False) for b in range(2)]
    inserted = int(c.torch.stack(
        [state.surf_map.count.sum(), state.corner_map.count.sum()]).sum())
    say(f"switches (c) batched motion_deskew (B=2, {T} distorted frames): "
        f"ATE per lane {[round(a, 5) for a in ates]} m (bound 0.1 m); "
        f"launches per frame {per_frame[0]}; {inserted} map points")
    one = {"pick_rounds": 1, "odo_corr": 4, "select_fit": 4}
    if not np.isfinite(est).all() or max(ates) >= 0.1 or \
            any(p != one for p in per_frame):
        fail(f"batched motion_deskew: ATE {ates}, launches {per_frame}")
    return per_frame


def lio_switch_phase(c):
    """(d) Pre-initialisation LIO frames with motion_deskew on the
    accelerating drive of tests/test_lio_pipeline.py."""
    fcfg = c.FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    cfg = c.MsfLoamConfig(
        features=fcfg, odometry=c.OdometryConfig(motion_deskew=True),
        mapping=c.MappingConfig(map_table_size=1 << 13,
                                max_query_points=2048),
        imu=c.ImuConfig(init_frames=6, warmup_msgs=10, max_imu_samples=64))
    acc, v_0 = np.array([2.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])
    pipe = c.SlamPipeline(cfg, device="cuda")
    t = 0.5
    while t < 1.0 + 9 * 0.1 + 0.2:
        pipe.add_imu(t, acc + LIO_G, np.zeros(3))
        t += 1.0 / 400
    p_first = v_0 * 1.0 + 0.5 * acc
    errs = []
    for i in range(9):
        ts = 1.0 + 0.1 * i
        p = v_0 * ts + 0.5 * acc * ts * ts
        xyz, ring = c.synthetic.simulate_scan(
            c.lio_world, p, np.eye(3), n_rings=16, pts_per_ring=900,
            noise=0.004, seed=i, linear_vel=v_0 + acc * ts, yaw_rate=0.0)
        img = c.preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=16,
                                           device=c.dev)
        feats = c.features.extract_features(
            img, c.torch.tensor(ts, dtype=c.torch.float32, device=c.dev),
            fcfg)
        pipe.process_scan(feats)
        errs.append(float(np.linalg.norm(pipe.pose_map.t.cpu().numpy()
                                         - (p - p_first))))
    g = pipe.gravity.cpu().numpy()
    tilt = float(np.linalg.norm(np.cross(g, LIO_G))
                 / (np.linalg.norm(g) * 9.81))
    stages = sorted(pipe.metrics()["stages"])
    say(f"switches (d) LIO pre-init motion_deskew (accelerating drive, 9 "
        f"frames): initialised {pipe.is_initialized}, largest mapped "
        f"position error {max(errs):.5f} m (bound 0.08 m), gravity tilt "
        f"sin {tilt:.5f} (bound 0.05); stages {stages}")
    if not pipe.is_initialized or max(errs) >= 0.08 or tilt >= 0.05:
        fail(f"LIO motion_deskew: errors {errs}, tilt {tilt}")


def checkpoint_phase(c):
    """(e) Checkpoint after frame 3 of 6 full-width lidar frames, resumed
    in a fresh pipeline on the card; the file also loads on the CPU."""
    import tempfile
    from msf_loam_tpu_torch.slam import checkpoint
    cfg = switched(c.cfg, motion_deskew=True)
    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(6), 0.004, lambda i: 100 + i, c.dev)
    a = c.SlamPipeline(cfg, device="cuda")
    b = c.SlamPipeline(cfg, device="cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        path = os.path.join(d, "state.npz")
        for i, img in enumerate(imgs):
            a.process_ring_image(img, 0.1 * i)
            if i < 3:
                b.process_ring_image(img, 0.1 * i)
            if i == 2:
                t0 = time.perf_counter()
                checkpoint.save_checkpoint(b, path)
                save_s = time.perf_counter() - t0
                size = os.path.getsize(path)
        resumed = c.SlamPipeline(cfg, device="cuda")
        t0 = time.perf_counter()
        checkpoint.load_checkpoint(resumed, path)
        load_s = time.perf_counter() - t0
        resumed.prev_scan = b.prev_scan
        on_cpu = c.SlamPipeline(cfg, device="cpu")
        checkpoint.load_checkpoint(on_cpu, path)
    for i, img in enumerate(imgs[3:]):
        resumed.process_ring_image(img, 0.1 * (i + 3))
    ta, tr = a.trajectory(), resumed.trajectory()
    worst = float(np.abs(ta[3:, 1:8] - tr[3:, 1:8]).max())
    same_cpu = bool(c.torch.equal(on_cpu.surf_map.points,
                                  b.surf_map.points.cpu())) and \
        on_cpu.frame_idx == 3
    say(f"switches (e) checkpoint on the card: {size / 2**20:.2f} MiB, save "
        f"{save_s * 1e3:.1f} ms, load {load_s * 1e3:.1f} ms; frames 4-6 "
        f"resumed vs uninterrupted max |dpose| {worst:.2e} (bound 1e-5); "
        f"loads on the CPU with equal maps: {same_cpu}")
    if worst > 1e-5 or not same_cpu or len(tr) != 6:
        fail(f"checkpoint resume differs by {worst} (cpu load {same_cpu})")


def switch_phase(c):
    """Phase 8; returns each frame path's launches per frame."""
    out = dict(lidar=timed("switches: lidar motion_deskew",
                           lambda: lidar_switch_phase(c)),
               matcher=timed("switches: in-matcher deskew, triangle",
                             lambda: odometry_switch_phase(c)),
               batched=timed("switches: batched motion_deskew",
                             lambda: batch_switch_phase(c)))
    timed("switches: LIO pre-init motion_deskew", lambda: lio_switch_phase(c))
    timed("switches: checkpoint", lambda: checkpoint_phase(c))
    return out


# ------------------------------------------------ 9. ingest and the apps
# outputs of the app runs, under the checkout (.gitignore lists out/)
APP_DIR = os.path.join("out", "chip_smoke")
KITTI_FRAMES, NSH_FRAMES = 20, 230
# scripts/stream_producer.py --selftest --frames 55 --warmup_static 30
# --step 0.1 --speed 0.2, the scene of tests/test_stream.py:84-134
STREAM_FRAMES, STREAM_WARMUP, STREAM_STEP, STREAM_SPEED = 55, 30, 0.1, 0.2


def app_path(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), APP_DIR,
                        *parts)


# the fixtures phase 9 reads: the 64-ring KITTI-format sequence (HDL-64E
# density, ~115k points a scan) and the NSH-style ROS1 bag
# (tests/test_nsh_bag.py's parameters: 230 frames, 16 rings x 900 points,
# 400 Hz IMU, bz2). A pool of host processes ray-casts their scans after
# phase 1 and before phase 2, so no fixture work shares the host with a
# timed run.
def build_fixtures(c):
    """Write phase 9's fixtures; sets ``c.kitti64_root`` and
    ``c.nsh_bag_path``."""
    c.kitti64_root = app_path("kitti64")
    c.nsh_bag_path = app_path("nsh", "nsh.bag")
    os.makedirs(os.path.dirname(c.nsh_bag_path), exist_ok=True)
    n = os.cpu_count() or 1
    t0 = time.perf_counter()
    with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        c.kitti.make_synthetic_kitti_sequence(
            c.kitti64_root, "00", n_frames=KITTI_FRAMES, n_rings=64,
            pts_per_ring=1800, yaw_rate=0.1,
            world=c.synthetic.World.corridor(seed=2, size=15.0), pool=pool)
        t1 = time.perf_counter()
        info = c.nsh_bag.build_nsh_bag(c.nsh_bag_path, frames=NSH_FRAMES,
                                       pool=pool)
    say(f"fixtures, scans ray-cast by {n} host processes: KITTI-format "
        f"sequence {t1 - t0:.1f} s, NSH bag {info} "
        f"{time.perf_counter() - t1:.1f} s")


def run_app(c, main, argv, ok=(0,)):
    """An app's ``main(argv)`` in this process: (summary, launches), the
    launch counts set to 0 just before and read just after; an exit code
    outside ``ok`` fails."""
    out = io.StringIO()
    c.kernels.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    c.torch.cuda.synchronize()
    launches = dict(c.kernels.LAUNCHES)
    if rc not in ok:
        fail(f"{main.__module__} {' '.join(argv)}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1]), launches


class AppHooks:
    """Patches around one run_slam run: the pipeline it makes (each frame
    timed, with its launches and route) and the KITTI prefetcher's wait per
    frame."""

    def __init__(self, c):
        self.c = c
        self.pipes, self.frames, self.waits, self.seqs = [], [], [], []
        self.made = None
        self.saved = []

    def __enter__(self):
        c, rs = self.c, self.c.run_slam
        make = rs._make_pipeline
        ring_images = c.kitti.KittiSequence.ring_images
        hooks = self

        def make_pipeline(cfg, args):
            pipe = make(cfg, args)
            hooks.made = dict(c.kernels.LAUNCHES)
            hooks.pipes.append(pipe)
            inner = pipe.process_ring_image

            def frame(img, t):
                lio = bool(pipe.has_imu and pipe.is_initialized
                           and pipe._states and pipe.prev_scan is not None)
                before = dict(c.kernels.LAUNCHES)
                t0 = time.perf_counter()
                res = inner(img, t)        # returns host floats: synced
                hooks.frames.append(dict(
                    t0=t0, t1=time.perf_counter(), lio=lio,
                    launches={k: v - before[k]
                              for k, v in c.kernels.LAUNCHES.items()}))
                return res
            pipe.process_ring_image = frame
            return pipe

        def timed_ring_images(seq, *a, **kw):
            hooks.seqs.append(seq)
            gen = ring_images(seq, *a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(gen)
                except StopIteration:
                    return
                hooks.waits.append(time.perf_counter() - t0)
                yield item

        self.saved = [(rs, "_make_pipeline", make),
                      (c.kitti.KittiSequence, "ring_images", ring_images)]
        rs._make_pipeline = make_pipeline
        c.kitti.KittiSequence.ring_images = timed_ring_images
        return self

    def __exit__(self, *exc):
        restore(self.saved)

    def after_frames(self, launches):
        """The launches of the run's shutdown step (loop closure, the pose
        graph), from its total: those after the pipeline was made, less
        the frames' own."""
        return {k: v - self.made[k] - sum(f["launches"][k]
                                          for f in self.frames)
                for k, v in launches.items()}

    def steady_scans_per_s(self, warm=5, lio_only=False):
        fr = [f for f in self.frames if f["lio"] or not lio_only]
        if len(fr) <= warm:
            return float("nan")
        return (len(fr) - warm) / sum(f["t1"] - f["t0"] for f in fr[warm:])


def trace_kernels(path):
    """Device time and count of each hand-written kernel in a Chrome trace
    written by torch.profiler, and the trace's device-busy share."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    out = {}
    for name, key in DEVICE_KERNEL.items():
        mine = [e["dur"] for e in kern if key in e.get("name", "")]
        if mine:
            out[name] = (sum(mine) / 1e3, len(mine))
    if not kern:
        return out, None
    span = (max(e["ts"] + e["dur"] for e in kern)
            - min(e["ts"] for e in kern))
    return out, sum(e["dur"] for e in kern) / span


def kitti_app_phase(c):
    """(a) run_slam --kitti_root on a 20-frame, 64-ring KITTI-format
    sequence (HDL-64E density, ~115k points a scan): the profiled run
    (launches, artifacts, trace), the speed run, CPU parity. Returns the
    speed run's summary, launches and output directory."""
    root = c.kitti64_root
    n_pts = np.fromfile(os.path.join(root, "sequences", "00", "velodyne",
                                     "000000.bin"), np.float32).size // 4
    say(f"KITTI-format sequence: {KITTI_FRAMES} frames, 64 rings x 1800 "
        f"columns, World.corridor(seed=2, size=15.0), 0.1 rad/s yaw, "
        f"{n_pts} points in frame 0")
    t0 = time.perf_counter()
    if not c.runtime.available():
        fail("the native C++ runtime (msf_loam_tpu_torch/runtime) did not "
             "build on this host")
    say(f"native runtime built and loaded in {time.perf_counter() - t0:.1f} "
        f"s: {os.path.relpath(c.runtime.library_path())}")
    base = ["--kitti_root", root, "--n_rings", "64", "--eval", "--sim_gps",
            "--posegraph", "--save_map", "--pbstream", "--quiet"]
    iters = c.MsfLoamConfig().posegraph.iterations
    want = {"pick_rounds": KITTI_FRAMES + 1, "odo_corr": 4 * KITTI_FRAMES,
            "select_fit": 4 * KITTI_FRAMES, "knn": 0, "block_tridiag": iters, **SPLIT_ZERO}

    prof_dir = app_path("kitti64_profile")
    s, launches = run_app(c, c.run_slam.main, base + [
        "--profile_dir", prof_dir, "--output_dir", app_path("kitti64_a")])
    trace = os.path.join(prof_dir, "trace.json")
    t0 = time.perf_counter()
    dev, busy = trace_kernels(trace)
    say(f"run_slam --kitti_root ... --profile_dir (profiled): {s}; launches "
        f"{launches}; trace {os.path.getsize(trace) / 2**20:.1f} MiB, "
        f"read in {time.perf_counter() - t0:.1f} s, device busy "
        f"{100 * (busy or 0):.1f}% of the kernels' span")
    for name, (ms, n) in dev.items():
        say(f"  trace: {name} {ms:.3f} ms over {n} launches "
            f"({ms / n:.4f} ms a launch, 64-ring shapes)")
    missing = [k for k in ("pick_rounds", "odo_corr", "select_fit",
                           "block_tridiag") if k not in dev]
    if missing or launches != want:
        fail(f"64-ring profiled run: kernels {missing} missing from the "
             f"trace, launches {launches}, expected {want}")

    out = app_path("kitti64_b")
    torch = c.torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with AppHooks(c) as h:
        s, launches = run_app(c, c.run_slam.main,
                              base + ["--output_dir", out])
    peak = torch.cuda.max_memory_allocated()
    pipe = h.pipes[0]
    raw = pipe.trajectory()
    stages = pipe.metrics()["stages"]
    waits = np.asarray(h.waits) * 1e3
    say(f"run_slam --kitti_root --n_rings 64 --eval --sim_gps --posegraph "
        f"--save_map --pbstream: {s}")
    say(f"  64-ring app speed: {h.steady_scans_per_s():.2f} scans/s steady "
        f"state (frames 5-{KITTI_FRAMES - 1}), app summary "
        f"{s['scans_per_sec']} scans/s over its whole run; ingest "
        f"(prefetcher wait + copy to the card) median {np.median(waits):.2f}"
        f" ms, max {waits.max():.2f} ms a scan; peak device memory "
        f"{peak / 2**20:.1f} MiB; launches {launches}")
    say("  64-ring frame stages (metrics(), host clock, issue time, mean ms):"
        + ", ".join(f" {k} {v['mean_ms']:.2f}" for k, v in stages.items()))
    native = [sq.native for sq in h.seqs]
    if (s["frames"] != KITTI_FRAMES or not s["ate_rmse_m"] < 0.1
            or launches != want or native != [True]
            or len(waits) != KITTI_FRAMES):
        fail(f"64-ring KITTI app run: summary {s}, launches {launches} "
             f"(expected {want}), native prefetcher {native} on "
             f"{len(waits)} frames")
    ply = c.artifacts.load_ply(os.path.join(out, "msf_loam_cloud.ply"))
    pb = c.proto.read_pbstream(os.path.join(out, "trajectory.pbstream"))
    traj = c.artifacts.load_trajectory(os.path.join(out, "trajectory.npz"))
    if len(ply) != s["map_points"] or not (
            np.array_equal(pb["translation"], traj["translation"])
            and np.array_equal(pb["rotation_wxyz"], traj["rotation_wxyz"])):
        fail("64-ring KITTI app run: PLY or pbstream does not read back")
    say(f"  artifacts read back: PLY {len(ply)} points, pbstream "
        f"{len(pb['times'])} poses equal to trajectory.npz")

    t0 = time.perf_counter()
    cpu_s, _ = run_app(c, c.run_slam.main, [
        "--kitti_root", root, "--n_rings", "64", "--max_frames", "3",
        "--quiet", "--device", "cpu", "--output_dir", app_path("kitti64_cpu")])
    cpu = c.artifacts.load_trajectory(app_path("kitti64_cpu",
                                               "trajectory.npz"))
    worst = max(float(np.abs(cpu["translation"] - raw[:3, 1:4]).max()),
                float(np.abs(cpu["rotation_wxyz"] - raw[:3, 4:8]).max()))
    say(f"  run_slam --device cpu, 3 frames ({time.perf_counter() - t0:.1f} "
        f"s): mapped poses vs the card's max |dpose| {worst:.2e} "
        f"(tolerance 1e-3)")
    if cpu_s["frames"] != 3 or worst > 1e-3:
        fail(f"64-ring CPU parity: {worst}")
    return s, launches, out, root


def nsh_app_phase(c):
    """(b) run_slam --bag on the NSH-style ROS1 bag (tests/test_nsh_bag.py's
    workflow): bz2 bag -> npz conversion -> pre-init and LIO frames ->
    loop closure -> ATE."""
    bag = c.nsh_bag_path
    conv = {}
    bag_to_npz = c.rosbag.bag_to_npz

    def timed_conversion(*a, **kw):
        t = time.perf_counter()
        counts = bag_to_npz(*a, **kw)
        conv.update(counts, seconds=time.perf_counter() - t)
        return counts
    c.rosbag.bag_to_npz = timed_conversion
    odir = app_path("nsh_out")
    shutil.rmtree(odir, ignore_errors=True)
    try:
        with AppHooks(c) as h:
            s, launches = run_app(c, c.run_slam.main, [
                "--bag", bag, "--loop_closure", "--eval", "--n_rings", "16",
                "--pbstream", "--quiet", "--output_dir", odir])
    finally:
        c.rosbag.bag_to_npz = bag_to_npz
    lio = [f for f in h.frames if f["lio"]]
    pre = [f for f in h.frames if not f["lio"]]
    pre_ms = np.mean([f["t1"] - f["t0"] for f in pre]) * 1e3 if pre else 0
    per = {"pick_rounds": 1, "odo_corr": 4, "select_fit": 4, "knn": 0,
           "block_tridiag": 0, **SPLIT_ZERO}
    bad = [f["launches"] for f in lio if f["launches"] != per]
    pre_l = {k: sorted({f["launches"][k] for f in pre}) for k in per}
    say(f"run_slam --bag nsh.bag --loop_closure --eval --n_rings 16 "
        f"--pbstream: {s}")
    say(f"  NSH bag: conversion {conv.get('seconds', float('nan')):.2f} s "
        f"({ {k: v for k, v in conv.items() if k != 'seconds'} }); "
        f"{len(pre)} pre-init frames ({pre_ms:.1f} ms each on average, "
        f"launches a frame {pre_l}), "
        f"{len(lio)} LIO frames at {h.steady_scans_per_s(lio_only=True):.2f}"
        f" scans/s steady, launches per post-init frame {per} on "
        f"{len(lio) - len(bad)} of {len(lio)}; loop-closure step launches "
        f"{h.after_frames(launches)}; run launches {launches}")
    if (s["frames"] != NSH_FRAMES or s.get("loop_edges", 0) < 1
            or not s["ate_rmse_m"] < 0.12 or not pre or not lio or bad
            or launches["block_tridiag"] != c.MsfLoamConfig().posegraph
            .iterations):
        fail(f"NSH bag app run: {s}, {len(pre)} pre-init / {len(lio)} LIO "
             f"frames, off-count frames {bad[:3]}, launches {launches}")
    return bag, odir


def stream_scene():
    """scripts/stream_producer.py's --selftest source: the run_slam
    --selftest corridor, static for the warm-up frames, then moving."""
    from msf_loam_tpu_torch.dataio import synthetic
    from msf_loam_tpu_torch.dataio.npz_bag import OdomMsg, ScanMsg
    world = synthetic.World.corridor(seed=0, size=12.0)
    msgs = []
    for i in range(STREAM_FRAMES):
        j = max(0, i - STREAM_WARMUP)
        t = np.array([STREAM_STEP * j, 0.1 * np.sin(0.2 * j), 0.0])
        yaw = 0.02 * j
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        xyz, ring = synthetic.simulate_scan(world, t, R, n_rings=16,
                                            pts_per_ring=1800, noise=0.004,
                                            seed=i)
        msgs.append(OdomMsg(time=0.1 * i, t=t.astype(np.float32),
                            q_wxyz=np.array([1.0, 0, 0, 0], np.float32)))
        msgs.append(ScanMsg(time=0.1 * i, xyz=xyz.astype(np.float32),
                            ring=ring.astype(np.int32)))
    return msgs


def stream_gt(tm):
    j = max(0, int(round(tm / 0.1)) - STREAM_WARMUP)
    return np.array([STREAM_STEP * j, 0.1 * np.sin(0.2 * j), 0.0])


def stream_phase(c):
    """(c) run_slam --listen fed from a thread by the port's stream_bag at
    the producer script's pacing, and run_slam --online on
    tests/test_bag.py's bag."""
    msgs = stream_scene()
    sock = app_path("msf.sock")
    if os.path.exists(sock):
        os.remove(sock)
    # a relative path keeps the socket name under the 108-byte limit
    addr = "unix:" + os.path.relpath(sock)
    sent = {}

    def produce():
        sent["n"] = c.stream.stream_bag(types.SimpleNamespace(
            replay=lambda: iter(msgs)), addr, speed=STREAM_SPEED)
    th = threading.Thread(target=produce, daemon=True)
    th.start()
    odir = app_path("stream_out")
    try:
        s, launches = run_app(c, c.run_slam.main, [
            "--listen", addr, "--eval", "--quiet", "--n_rings", "16",
            "--output_dir", odir])
    finally:
        th.join(timeout=120)
    n_scans = STREAM_FRAMES
    traj = c.artifacts.load_trajectory(os.path.join(odir, "trajectory.npz"))
    times, est = traj["times"], traj["translation"]
    step_err = max(float(np.abs((est[a] - est[a - 1]) - (
        stream_gt(times[a]) - stream_gt(times[a - 1]))).max())
        for a in range(len(times) - 4, len(times)))
    end_err = float(np.linalg.norm(est[-1] - stream_gt(times[-1])))
    say(f"run_slam --listen (unix socket, {n_scans} scans paced at speed "
        f"{STREAM_SPEED}): {s}; sent {sent.get('n')} messages; processed "
        f"{s['frames']} + dropped {s['dropped_scans']} scans; last 4 steps "
        f"within {step_err:.4f} m of ground truth (bound 0.08), final "
        f"position error {end_err:.4f} m (bound 0.3)")
    if (th.is_alive() or sent.get("n") != 2 * n_scans
            or s["frames"] + s["dropped_scans"] != n_scans
            or step_err > 0.08 or end_err >= 0.3):
        fail(f"stream run: {s}, sent {sent}, step {step_err}, end {end_err}")

    root = app_path("bag5")
    c.kitti.make_synthetic_kitti_sequence(root, "00", n_frames=5,
                                          pts_per_ring=1800)
    bag = os.path.join(root, "seq00.npz")
    c.npz_bag.bag_from_kitti(root, "00", bag, n_rings=16)
    s, _ = run_app(c, c.run_slam.main, [
        "--bag", bag, "--online", "--n_rings", "16", "--eval", "--quiet",
        "--output_dir", app_path("bag5_out")])
    say(f"run_slam --bag --online (tests/test_bag.py's 5-frame bag): {s}")
    if s["frames"] + s["dropped_scans"] != 5 or not s["ate_rmse_m"] < 0.08:
        fail(f"online run: {s}")


def calib_scene(c, path):
    """tests/test_apps.py:158-207's scene: a 3-axis gyro walk at 200 Hz, the
    lidar seeing it through a known extrinsic rotation; written as a
    pbstream. Returns that rotation."""
    torch, se3 = c.torch, c.se3
    q_ric = torch.tensor([0.96, 0.15, -0.1, 0.2])
    q_ric = q_ric / torch.linalg.vector_norm(q_ric)
    n_frames, imu_hz = 40, 200
    q_imu = [torch.tensor([1.0, 0.0, 0.0, 0.0])]
    imu_t, gyr = [], []
    for k in range((n_frames - 1) * imu_hz // 10):
        w = np.array([0.6 * np.sin(0.05 * k), 0.4 * np.cos(0.03 * k),
                      0.5 * np.sin(0.02 * k + 1)])
        imu_t.append(k / imu_hz)
        gyr.append(w)
        q_imu.append(se3.quat_normalize(se3.quat_multiply(
            q_imu[-1], se3.quat_exp(torch.tensor(w / imu_hz,
                                                 dtype=torch.float32)))))
    q_l = np.stack([se3.quat_multiply(se3.quat_multiply(
        q_ric, q_imu[min(i * imu_hz // 10, len(q_imu) - 1)]),
        se3.quat_conjugate(q_ric)).numpy() for i in range(n_frames)])
    c.proto.write_pbstream(path, np.arange(n_frames) * 0.1,
                           np.zeros((n_frames, 3)), q_l,
                           {"times": np.asarray(imu_t),
                            "angular_velocity": np.asarray(gyr)})
    return q_ric.numpy()


def apps_phase(c, kitti_out, kitti_root, nsh_bag, nsh_out, kitti_ate):
    """(d) evaluate, export_viz, calib_lidar_imu, kitti_to_bag and
    rosbag_to_npz on (a)'s and (b)'s outputs."""
    traj = os.path.join(kitti_out, "trajectory.npz")
    s, _ = run_app(c, c.app_evaluate.main, ["--trajectory", traj,
                                            "--kitti_root", kitti_root])
    say(f"evaluate on (a): {s}")
    # run_slam's ate_rmse_m is the aligned one (as in the JAX package)
    if s["frames"] != KITTI_FRAMES or \
            abs(s["ate_rmse_aligned_m"] - kitti_ate) > 1e-4:
        fail(f"evaluate: {s} against run_slam's ATE {kitti_ate}")
    html = app_path("viz.html")
    s, _ = run_app(c, c.app_export_viz.main, [
        "--trajectory", traj, "--map", os.path.join(kitti_out,
                                                    "msf_loam_cloud.ply"),
        "--output", html])
    say(f"export_viz on (a): {s}, {os.path.getsize(html)} bytes")
    if s["poses"] != KITTI_FRAMES or not s["map_points"]:
        fail(f"export_viz: {s}")
    pbs = app_path("calib.pbstream")
    q_ric = calib_scene(c, pbs)
    t0 = time.perf_counter()
    s, _ = run_app(c, c.app_calib.main, ["--trajectory", pbs])
    t_card = time.perf_counter() - t0
    s_cpu, _ = run_app(c, c.app_calib.main, ["--trajectory", pbs,
                                             "--device", "cpu"])
    dot = abs(float(np.asarray(s["q_ric_wxyz"]) @ q_ric))
    dq = float(np.abs(np.asarray(s["q_ric_wxyz"])
                      - np.asarray(s_cpu["q_ric_wxyz"])).max())
    nsh_pb = os.path.join(nsh_out, "trajectory.pbstream")
    s2, _ = run_app(c, c.app_calib.main, ["--trajectory", nsh_pb],
                    ok=(0, 1))
    say(f"calib_lidar_imu on the card ({t_card:.2f} s) on tests/test_apps.py"
        f"'s 3-axis scene (pbstream): {s}, |q . q_true| {dot:.6f} (bound "
        f"0.999); --device cpu: {s_cpu}, max |dq| {dq:.2e} (tolerance "
        f"1e-5); on (b)'s pbstream (a planar walk, yaw only: degenerate, not "
        f"gated): {s2}")
    if not s["converged"] or dot <= 0.999 or dq > 1e-5 \
            or s_cpu["n_pairs"] != s["n_pairs"]:
        fail(f"calib_lidar_imu: {s} on the card, {s_cpu} on the CPU")
    s, _ = run_app(c, c.app_kitti_to_bag.main, [
        "--kitti_root", kitti_root, "--output", app_path("k2b.npz"),
        "--imu_rate", "100", "--max_frames", "5"])
    s2, _ = run_app(c, c.app_rosbag_to_npz.main,
                    [nsh_bag, app_path("nsh.npz")])
    say(f"kitti_to_bag on (a): {s}; rosbag_to_npz on (b): {s2}")
    if s["scans"] != 5 or s2["scan"] != NSH_FRAMES or s2["odom"] != NSH_FRAMES:
        fail(f"kitti_to_bag {s}, rosbag_to_npz {s2}")


def selftest_gt(path, n):
    out = []
    for i in range(n):
        if path == "loop":
            fwd = i if i < n // 2 else (n - 1 - i)
            out.append([0.25 * fwd, 0.0, 0.0])
        else:
            out.append([0.25 * i, 0.1 * np.sin(0.2 * i), 0.0])
    return np.asarray(out)


def fusion_phase(c):
    """(e) run_slam --selftest's shutdown fusions (phase 7(b) before they
    ran through the app): the 30-frame out-and-back drive with proximity +
    scan matcher, scan context + scan matcher, proximity + submap matcher,
    --sim_gps --posegraph, and the 25-frame straight drive. Returns
    block_tridiag's launches over the five."""
    iters = c.MsfLoamConfig().posegraph.iterations
    runs = [("out-and-back, proximity + scan matcher", "loop", 30,
             ["--loop_closure"], 0.08),
            ("out-and-back, scan context + scan matcher", "loop", 30,
             ["--loop_closure", "--loop_detector", "scan_context"], 0.08),
            ("out-and-back, proximity + submap matcher", "loop", 30,
             ["--loop_closure", "--loop_edge_matcher", "submap"], 0.08),
            ("out-and-back, --sim_gps --posegraph", "loop", 30,
             ["--sim_gps", "--posegraph"], 0.1),
            ("straight, proximity + scan matcher", "line", 25,
             ["--loop_closure"], 0.08)]
    total = 0
    for k, (label, path, n, flags, bound) in enumerate(runs):
        t0 = time.perf_counter()
        with AppHooks(c) as h:
            s, launches = run_app(c, c.run_slam.main, [
                "--selftest", "--selftest_path", path, "--selftest_frames",
                str(n), "--eval", "--quiet", *flags,
                "--output_dir", app_path(f"fusion{k}")])
        step = h.after_frames(launches)
        gt = selftest_gt(path, n)
        before = c.ate_rmse(h.pipes[0].trajectory()[:, 1:4], gt - gt[0])
        total += launches["block_tridiag"]
        say(f"run_slam --selftest, {label}: {s}; ATE before fusion "
            f"{before:.5f} m (bound after {bound} m); {time.perf_counter() - t0:.1f}"
            f" s; run launches {launches}, shutdown step {step}")
        if not s["ate_rmse_m"] < bound or launches["block_tridiag"] != iters:
            fail(f"{label}: {s}, launches {launches}")
        if k == 0 and (s["loop_edges"] < 1 or not all(
                step[x] >= 1
                for x in ("odo_corr", "select_fit", "block_tridiag"))):
            fail(f"{label}: {s}, loop-closure step launches "
                 f"{step}")
        if k == 4 and s["loop_edges"]:
            fail(f"{label}: {s['loop_edges']} loop edges on a drive with no "
                 f"revisit")
    return total


def app_phase(c):
    """Phase 9; returns the 64-ring KITTI app run's launches and
    block_tridiag's launches over the shutdown fusions."""
    s, launches, kitti_out, kitti_root = timed(
        "apps: 64-ring KITTI-format run_slam", lambda: kitti_app_phase(c))
    nsh_bag, nsh_out = timed("apps: NSH ROS1 bag run_slam",
                             lambda: nsh_app_phase(c))
    timed("apps: --listen and --online", lambda: stream_phase(c))
    timed("apps: evaluate, export_viz, calib, converters",
          lambda: apps_phase(c, kitti_out, kitti_root, nsh_bag, nsh_out,
                             s["ate_rmse_m"]))
    fusions = timed("apps: shutdown fusions", lambda: fusion_phase(c))
    return launches, fusions


# ------------------------------------------------ 10. the distribution layer
DIST_FRAMES = 10                    # (a) accuracy and (b) world-2 drives
DIST_JOIN_S = 600                   # the world-2 children, together
# collectives a lidar frame of the sharded pipeline (2 odometry rounds of
# 6 GN iterations): 2 x (1 + 6) all-reduces, the map sizes' all-reduce,
# one all-gather per mapping round (2 rounds)
DIST_FRAME_COLLECTIVES = {"all_reduce": 15, "all_gather": 2}
# a Gauss-Newton iteration of optimize_with_loops_distributed: the
# separator gather, the capacitance all-reduce, the solution gather
DIST_PG_COLLECTIVES = {"all_reduce": 1, "all_gather": 2}
DIST_PG_LAUNCHES = {"block_tridiag_condense": 1, "block_tridiag": 1,
                    "block_tridiag_backsub": 1}


def per_round(cfg):
    """``cfg`` on the per-round association path (the sharded hooks')."""
    import dataclasses
    return dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, reuse_candidates=False))


def nonzero(d):
    return {k: v for k, v in d.items() if v}


def split_work(bt, N, m):
    """(bytes, float operations) of block_tridiag's condense launch and of
    its back-substitute launch, split as tridiag_work counts the one-launch
    solve: the condense launch reads D, U, B once and writes each interior
    step's residues (factor, S0k, bk, pivots) and the separator chain; the
    back-substitute launch reads the residues, U and the solved separators
    and writes X."""
    L, P = bt.segments(N)
    factor = sum((5 - k) + 2 * (5 - k) ** 2 for k in range(6))
    solve_col = 2 * 15 + 6 + 2 * 15
    interior = max(N - 2 * P, 0)
    res = 4 * interior * (36 + 36 + 6 * m + 6)
    chain = 4 * 2 * P * (36 + 36 + 6 * m)
    c_bytes = 4 * (36 * N + 36 * (N - 1) + 6 * m * N) + res + chain
    c_ops = interior * (factor + (12 + m) * solve_col + 12 * 6 * (12 + m)
                        + 12 * 6 * (6 + m))
    b_bytes = res + 4 * (36 * (N - 1) + 2 * P * 6 * m + 6 * m * N)
    b_ops = interior * m * (2 * 12 * 6 + solve_col)
    return (c_bytes, c_ops), (b_bytes, b_ops)


def profile_collectives(torch, run, label):
    """A torch.profiler trace of ``run``: device busy, and the device time
    a collective (NCCL kernels), beside profile_frames' summary."""
    prof = profile_frames(torch, run, label)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    nccl = [e for e in device_events(p) if "nccl" in e.key.lower()]
    us, n = sum(self_dev_us(e) for e in nccl), sum(e.count for e in nccl)
    host = [e for e in p.key_averages() if e.key.startswith("c10d::")
            or "nccl:" in e.key]
    say(f"  collectives in the trace of {label}: device {us / 1e3:.3f} ms "
        f"over {n} NCCL kernels ({us / max(n, 1):.1f} us each); host ops "
        + ", ".join(f"{e.key} {e.count}x {e.cpu_time_total / max(e.count, 1):.1f}"
                    f" us" for e in host[:6]))
    return prof, us, n


def dist_namespace(c):
    """The distribution modules, on ``c``."""
    from msf_loam_tpu_torch.apps import bench_scaling
    from msf_loam_tpu_torch.parallel import distributed_ba, runtime
    from msf_loam_tpu_torch.parallel import mesh as mesh_mod
    from msf_loam_tpu_torch.parallel import sharded_map, sharded_pipeline
    from msf_loam_tpu_torch.slam import checkpoint
    c.runtime_pg, c.mesh_mod, c.sharded_map = runtime, mesh_mod, sharded_map
    c.sp = sharded_pipeline
    c.dba, c.checkpoint, c.bench_scaling = distributed_ba, checkpoint, \
        bench_scaling
    return c


def sharded_drive(c, mesh, cfg, imgs, stamps=None):
    """The sharded pipeline over ``imgs``; returns it."""
    pipe = c.sp.ShardedSlamPipeline(cfg, mesh)
    for i, img in enumerate(imgs):
        pipe.process_ring_image(img, 0.1 * i)      # returns host floats
        if stamps is not None:
            stamps.append(time.perf_counter())
    return pipe


def dist_world1_phase(c):
    """(a) The sharded pipeline at world size 1 over NCCL, full width."""
    torch, kernels, mm = c.torch, c.kernels, c.mesh_mod
    mesh = mm.make_mesh(n_map=1)
    say(f"distribution (a): world {mesh.world_size} over {mesh.backend} on "
        f"{mesh.device}, mesh (data, map) = ({mesh.n_data}, {mesh.n_map})")
    world = c.synthetic.World.corridor(seed=0, size=12.0)
    drive = corridor_drive(DIST_FRAMES)
    imgs = images(c.synthetic, c.preprocess, c.cfg.features, world, drive,
                  0.005, lambda i: 3, c.dev)
    pipe = sharded_drive(c, mesh, c.cfg, imgs)
    traj = pipe.trajectory()
    gt = np.asarray([t for t, _ in drive])
    ate = c.ate_rmse(traj[:, 1:4], gt, align=False)
    dense = c.SlamPipeline(per_round(c.cfg), device="cuda")
    cached = c.SlamPipeline(c.cfg, device="cuda")
    for i, img in enumerate(imgs):
        dense.process_ring_image(img, 0.1 * i)
        cached.process_ring_image(img, 0.1 * i)
    d_dense = float(np.abs(traj[:, 1:8] - dense.trajectory()[:, 1:8]).max())
    d_cached = float(np.abs(traj[:, 1:4] - cached.trajectory()[:, 1:4]).max())
    pts = pipe.map_points()
    say(f"distribution (a) accuracy: ATE {ate:.5f} m over {DIST_FRAMES} "
        f"corridor frames (bound 0.05 m); max |dpose| against the dense "
        f"frame on the same path (reuse_candidates=False) {d_dense:.2e} "
        f"(bound 5e-3); against the dense cached-candidate frame "
        f"{d_cached:.2e} m (not gated: another association); map points "
        f"{pts.tolist()} (dense {int(dense.corner_map.count.sum())}, "
        f"{int(dense.surf_map.count.sum())})")
    if not ate < 0.05 or d_dense > 5e-3:
        fail(f"sharded world 1: ATE {ate}, |dpose| to dense {d_dense}")
    c.dist_ref = dict(traj=traj, dense=dense.trajectory(), points=pts,
                      dense_points=(int(dense.corner_map.count.sum()),
                                    int(dense.surf_map.count.sum())))

    # the plain versions on the CPU, over gloo, from the same frames
    gloo = torch.distributed.new_group([0], backend="gloo")
    cmesh = mm.make_mesh(n_map=1, group=gloo, device="cpu")
    cpu = sharded_drive(c, cmesh, c.cfg, [im.to("cpu") for im in imgs[:3]])
    worst = float(np.abs(cpu.trajectory()[:, 1:8] - traj[:3, 1:8]).max())
    say(f"distribution (a) cpu plain versions (gloo) vs card, 3 frames: max "
        f"|dpose| {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"sharded CPU and card poses differ by {worst}")

    n = LIDAR_FRAMES
    bench = images(c.synthetic, c.preprocess, c.cfg.features, c.bench_world,
                   bench_drive(n), 0.004, lambda i: 100 + i, c.dev)
    speeds = {}
    for name, make in (
            ("sharded", lambda: None),
            ("dense cached", lambda: c.SlamPipeline(c.cfg, device="cuda")),
            ("dense per-round",
             lambda: c.SlamPipeline(per_round(c.cfg), device="cuda"))):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        mm.reset_collective_counts()
        stamps = []
        t0 = time.perf_counter()
        if name == "sharded":
            run = sharded_drive(c, mesh, c.cfg, bench, stamps)
            launches = dict(kernels.LAUNCHES)
            coll = dict(mm.COLLECTIVES)
        else:
            p = make()
            for i, img in enumerate(bench):
                p.process_ring_image(img, 0.1 * i)
                stamps.append(time.perf_counter())
        speeds[name] = (n - 5) / (stamps[-1] - stamps[4])
    want = dict({k: 0 for k in kernels.LAUNCHES}, pick_rounds=n,
                odo_corr=4 * n, select_fit=2 * n)
    want_c = {k: v * n for k, v in DIST_FRAME_COLLECTIVES.items()}
    say(f"distribution (a) speed, {n} bench frames (steady frames 5-"
        f"{n - 1}): sharded world 1 {speeds['sharded']:.2f} scans/s; dense "
        f"cached-candidate frame {speeds['dense cached']:.2f} scans/s; dense "
        f"per-round frame {speeds['dense per-round']:.2f} scans/s; sharded "
        f"launches {nonzero(launches)}, collectives {coll}")
    if launches != want or coll != want_c:
        fail(f"sharded world 1: launches {launches} (expected {want}), "
             f"collectives {coll} (expected {want_c})")

    def run3():
        for i, img in enumerate(bench[:3]):
            run.process_ring_image(img, 3.0 + 0.1 * i)
    profile_collectives(torch, run3, "sharded world 1, 3 frames")
    return launches, speeds


def lio_sharded_step(c, mesh, pipe, img, ts):
    """One post-initialisation LIO frame through sharded_lio_frame, from and
    back into the dense pipeline's state (at world 1 the shards are the
    whole maps): ``SlamPipeline._process_lio_fused`` with the hooks."""
    cfg, torch = pipe.cfg, c.torch
    prev = pipe._states[-1]
    (pipe.corner_map, pipe.surf_map, pipe.pose_curr2last, pipe.pose_odom,
     pipe.pose_odom2map, pipe.pose_map, pipe.velocity, n_corr, ok,
     scan) = c.sp.sharded_lio_frame(
        mesh, cfg, pipe.corner_map, pipe.surf_map, pipe.prev_scan, img,
        torch.tensor(ts, device=c.dev), pipe.pose_curr2last, pipe.pose_odom,
        pipe.pose_odom2map, torch.tensor(False, device=c.dev),
        *pipe._window(prev["time"], ts),
        *pipe._window(ts, ts + cfg.features.scan_period), prev["p"],
        prev["q"], prev["v"], pipe.gravity, ba=pipe.bias_acc,
        bg=pipe.bias_gyr)
    pipe._estimator_add(ts, pipe.pose_map, pipe.velocity)
    return pipe._finish(scan, ts, n_corr, ok)


def dist_lio_phase(c):
    """(c) The sharded LIO frame at world 1 on the distorted LIO drive,
    tight coupling on."""
    kernels, mm = c.kernels, c.mesh_mod
    mesh = mm.make_mesh(n_map=1)
    fcfg = c.FeatureConfig(max_points_per_ring=2048, max_less_flat=4096)
    n = 9
    imgs, gt = lio_images(c.synthetic, c.preprocess, fcfg, c.lio_world, n,
                          c.dev)
    cfg = per_round(c.MsfLoamConfig(
        features=fcfg, mapping=c.MappingConfig(map_table_size=1 << 13,
                                               max_query_points=2048),
        imu=c.ImuConfig(init_frames=6, warmup_msgs=10, max_imu_samples=64,
                        tight_coupling=True)))
    pipe = c.SlamPipeline(cfg, device="cuda")
    lio_feed_imu(pipe, n)
    per_frame, n_sharded = [], 0
    for i, img in enumerate(imgs):
        ts = LIO_T0 + 0.1 * i
        kernels.reset_launch_counts()
        mm.reset_collective_counts()
        if pipe.is_initialized and pipe._states and \
                pipe.prev_scan is not None:
            lio_sharded_step(c, mesh, pipe, img, ts)
            n_sharded += 1
            c.torch.cuda.synchronize()
            per_frame.append((dict(kernels.LAUNCHES), dict(mm.COLLECTIVES)))
        else:
            pipe.process_ring_image(img, ts)
    traj = pipe.trajectory()
    ate = c.ate_rmse(traj[:, 1:4], gt, align=False)
    want = dict({k: 0 for k in kernels.LAUNCHES}, pick_rounds=1, odo_corr=4,
                select_fit=2)
    bad = [f for f in per_frame if f[0] != want
           or f[1] != DIST_FRAME_COLLECTIVES]
    say(f"distribution (c) sharded LIO frame, world 1, tight coupling: ATE "
        f"{ate:.4f} m over {n} frames (bound 0.15 m), {n_sharded} sharded "
        f"post-init frames, each {nonzero(want)} launches and "
        f"{DIST_FRAME_COLLECTIVES} collectives"
        + (f"; off: {bad}" if bad else ""))
    if not ate < 0.15 or not n_sharded or bad:
        fail(f"sharded LIO: ATE {ate}, {n_sharded} frames, counts {bad}")


def check_split(c, D, U, B, seg_len, tag):
    """block_tridiag_condense and _backsub bit-equal to their plain
    versions (the separator chain, then X from the same solved chain)."""
    torch, bt = c.torch, c.bt
    cp = bt.block_tridiag_condense_plain(D, U, B, seg_len)
    ck = bt.block_tridiag_condense(D, U, B, seg_len)
    for name in ("Dg", "Ug", "Bg"):
        a, b = getattr(ck, name), getattr(cp, name)
        if not torch.equal(a, b):
            fail(f"block_tridiag_condense {tag}: {name} differs from the "
                 f"plain version by {float((a - b).abs().max())}")
    xg = bt.block_tridiag(ck.Dg, ck.Ug, ck.Bg)
    Xk = bt.block_tridiag_backsub(ck, xg)
    Xp = bt.block_tridiag_backsub_plain(cp, xg)
    if not torch.equal(Xk, Xp) or not torch.isfinite(Xk).all():
        fail(f"block_tridiag_backsub {tag}: differs from its plain version "
             f"by {float((Xk - Xp).abs().max())}")
    return ck, cp, xg, Xk


def dist_pg_phase(c, rows):
    """(d) The distributed pose graph at KITTI-00 size, world 1, and the
    condense / back-substitute launches against their plain versions."""
    torch, bt, pg, kernels, mm = c.torch, c.bt, c.pg, c.kernels, c.mesh_mod
    mesh = mm.make_mesh(n_map=1, n_data=1)
    rng = np.random.default_rng(1)
    shapes = [(2, 1, None), (3, 49, None), (20, 1, None), (64, 49, None),
              (23, 4, 5), (9, 4, 4), (30, 49, 30), (4096, 49, None)]
    for N, m, seg_len in shapes:
        check_split(c, *seeded_tridiag(torch, rng, N, m, c.dev), seg_len,
                    f"N={N} m={m} seg_len={seg_len}")
    say(f"block_tridiag_condense and _backsub on seeded systems (N, m, "
        f"seg_len) {shapes}: each bit-equal to its plain version")
    prob = pg_problem(c, PG_KITTI_N, PG_LOOPS, c.dev)
    gt_t, poses0, data, loops = prob
    cfg = c.sim_cfg.posegraph
    D, U, B = first_gn_system(c, poses0, data, loops, cfg)
    N, m = B.shape[0], B.shape[2]
    ck, cp, xg, Xk = check_split(c, D, U, B, None, "KITTI-size")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bt.block_tridiag_condense_plain(D, U, B)
    torch.cuda.synchronize()
    c_plain = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bt.block_tridiag_backsub_plain(cp, xg)
    torch.cuda.synchronize()
    b_plain = (time.perf_counter() - t0) * 1e3
    one = bt.block_tridiag(D, U, B)
    err = float((Xk - one).abs().max() / one.abs().max())
    say(f"distribution (d): block_tridiag_condense and _backsub on the "
        f"KITTI-size first GN system (N={N}, m={m}, L, P = "
        f"{bt.segments(N)}): each bit-equal to its plain version; the split "
        f"solve against the one-launch solve: max relative difference "
        f"{err:.2e}")
    (cb, co), (bb, bo) = split_work(bt, N, m)
    for key, fn, plain_ms, nb, no in (
            ("block_tridiag_condense",
             lambda: bt.block_tridiag_condense(D, U, B), c_plain, cb, co),
            ("block_tridiag_backsub",
             lambda: bt.block_tridiag_backsub(ck, xg), b_plain, bb, bo)):
        t = dict(ms=cuda_ms(torch, fn, reps=PG_REPS),
                 batch_ms=batch_ms(torch, fn, reps=PG_REPS),
                 plain_ms=plain_ms)
        dev_ms = device_only_ms(torch, fn, DEVICE_KERNEL[key], reps=PG_REPS)
        t["device_ms"] = dev_ms if dev_ms is not None else t["batch_ms"]
        t["device_from"] = "profiler" if dev_ms is not None else "batch"
        rows[key] = Row()
        rows[key].add(t, nb, no)
        b, by = bound_ms(nb, no)
        say(f"{key} N={N} m={m}: {fmt(t)}; bound {b * 1e3:.2f} us ({by}: "
            f"{nb / 1e6:.1f} MB, {no / 1e6:.1f} Mflop)")

    def errs(poses):
        t = poses.t[:len(gt_t)].cpu().numpy()
        return float(np.linalg.norm(t - gt_t, axis=1).mean())
    ref = pg.optimize_with_loops(poses0, data, loops, cfg, n_iters=10)
    run = lambda: pg.optimize_with_loops_distributed(
        mesh, poses0, data, loops, cfg, n_iters=10)
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mm.reset_collective_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, coll = dict(kernels.LAUNCHES), dict(mm.COLLECTIVES)
    # the real poses: the padding (3651 poses chained to the last real
    # one by identity measurements, no GPS) is discarded by every caller,
    # and its far end moves by decimetres between two exact float32 solves
    n = len(gt_t)
    worst = float(torch.maximum(
        (out.poses.t[:n] - ref.poses.t[:n]).abs().max(),
        (out.poses.q[:n] - ref.poses.q[:n]).abs().max()))
    tail = float((out.poses.t[n:] - ref.poses.t[n:]).abs().max())
    t1 = time.perf_counter()
    ref = pg.optimize_with_loops(poses0, data, loops, cfg, n_iters=10)
    torch.cuda.synchronize()
    wall_ref = time.perf_counter() - t1
    want = dict({k: 0 for k in kernels.LAUNCHES},
                **{k: 10 * v for k, v in DIST_PG_LAUNCHES.items()})
    want_c = {k: 10 * v for k, v in DIST_PG_COLLECTIVES.items()}
    say(f"distribution (d) optimize_with_loops_distributed, world 1, N="
        f"{N}, 10 iterations: {wall * 1e3:.1f} ms wall (optimize_with_loops "
        f"{wall_ref * 1e3:.1f} ms); max |dpose| against optimize_with_loops "
        f"over the {n} real poses {worst:.2e} (bound 1e-3; the padding's "
        f"{tail:.2e} m, not gated); cost {float(ref.final_cost):.6g} / "
        f"{float(out.final_cost):.6g}; mean position error {errs(out.poses):.3f}"
        f" m; per GN iteration {nonzero({k: v / 10 for k, v in launches.items()})}"
        f" launches, {({k: v / 10 for k, v in coll.items()})} collectives")
    if worst > 1e-3 or launches != want or coll != want_c:
        fail(f"distributed pose graph: |dpose| {worst}, launches "
             f"{launches} (expected {want}), collectives {coll} (expected "
             f"{want_c})")
    c.dist_pg_ref = (ref.poses.t.cpu().numpy(), ref.poses.q.cpu().numpy())
    return launches


def dist_apps_phase(c):
    """(e) run_slam --map_shards 1, a sharded checkpoint, bench_scaling."""
    torch, mm = c.torch, c.mesh_mod
    s, launches = run_app(c, c.run_slam.main, [
        "--kitti_root", c.kitti64_root, "--n_rings", "64", "--eval",
        "--map_shards", "1", "--quiet", "--output_dir",
        app_path("kitti64_shard1")])
    want = dict({k: 0 for k in c.kernels.LAUNCHES},
                pick_rounds=KITTI_FRAMES, odo_corr=4 * KITTI_FRAMES,
                select_fit=2 * KITTI_FRAMES)
    say(f"distribution (e) run_slam --kitti_root (64 rings) --map_shards 1 "
        f"--eval: {s}; launches {nonzero(launches)}")
    if s["frames"] != KITTI_FRAMES or not s["ate_rmse_m"] < 0.1 or \
            launches != want:
        fail(f"run_slam --map_shards 1: {s}, launches {launches} (expected "
             f"{want})")

    import tempfile
    mesh = mm.make_mesh(n_map=1)
    cfg = switched(c.cfg, motion_deskew=True)
    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(6), 0.004, lambda i: 100 + i, c.dev)
    full = sharded_drive(c, mesh, cfg, imgs)
    half = sharded_drive(c, mesh, cfg, imgs[:3])
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        path = os.path.join(d, "sharded.npz")
        c.checkpoint.save_sharded_checkpoint(half, path)
        resumed = c.sp.ShardedSlamPipeline(cfg, mesh)
        c.checkpoint.load_sharded_checkpoint(resumed, path)
    resumed.prev_scan = half.prev_scan
    for i, img in enumerate(imgs[3:]):
        resumed.process_ring_image(img, 0.1 * (i + 3))
    worst = float(np.abs(full.trajectory()[3:, 1:8]
                         - resumed.trajectory()[3:, 1:8]).max())
    say(f"distribution (e) sharded checkpoint at world 1 after frame 3 of 6: "
        f"frames 4-6 resumed vs uninterrupted max |dpose| {worst:.2e} "
        f"(bound 1e-5)")
    if worst > 1e-5:
        fail(f"sharded checkpoint resume differs by {worst}")

    s, _ = run_app(c, c.bench_scaling.main, ["--pipeline"])
    say(f"distribution (e) bench_scaling at world 1: {s}")
    if not s["steps_per_sec"] > 0:
        fail(f"bench_scaling: {s}")


def dist_child(rank, init, out_path):
    """One rank of phase 10's world of 2 on the one card (gloo): (b) the
    sharded pipeline's corridor drive and (d) the distributed pose graph;
    its results pickled to ``out_path``."""
    import pickle

    import torch
    c = dist_namespace(namespace(torch))
    torch = c.torch
    c.runtime_pg.initialize(coordinator=init, num_processes=2,
                            process_id=rank, backend="gloo", device="cuda:0",
                            timeout_s=DIST_JOIN_S)
    mm, kernels = c.mesh_mod, c.kernels
    mesh = mm.make_mesh(n_map=2, device="cuda:0")
    world = c.synthetic.World.corridor(seed=0, size=12.0)
    imgs = images(c.synthetic, c.preprocess, c.cfg.features, world,
                  corridor_drive(DIST_FRAMES), 0.005, lambda i: 3, c.dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mm.reset_collective_counts()
    t0 = time.perf_counter()
    pipe = sharded_drive(c, mesh, c.cfg, imgs)
    wall = time.perf_counter() - t0
    res = dict(launches=dict(kernels.LAUNCHES),
               collectives=dict(mm.COLLECTIVES), wall=wall,
               traj=pipe.trajectory(), local=(
                   int(pipe.corner_map.count.sum()),
                   int(pipe.surf_map.count.sum())),
               points=pipe.map_points())
    mesh_d = mm.make_mesh(n_map=1, n_data=2, device="cuda:0")
    _, poses0, data, loops = pg_problem(c, PG_KITTI_N, PG_LOOPS, c.dev)
    cfg = c.sim_cfg.posegraph
    run = lambda: c.pg.optimize_with_loops_distributed(
        mesh_d, poses0, data, loops, cfg, n_iters=10)
    run()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    mm.reset_collective_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    res["pg"] = dict(t=out.poses.t.cpu().numpy(), q=out.poses.q.cpu().numpy(),
                     wall=time.perf_counter() - t0,
                     launches=dict(kernels.LAUNCHES),
                     collectives=dict(mm.COLLECTIVES))
    with open(out_path, "wb") as f:
        pickle.dump(res, f)
    c.runtime_pg.shutdown()


def dist_world2_phase(c):
    """(b) and (d) at world 2: two processes on the one card over gloo
    (NCCL refuses two ranks on one GPU); a check that the logic holds
    with the kernels on the card, not a speed figure."""
    import pickle
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        init = "file://" + os.path.join(d, "rendezvous")
        code = "import chip_smoke as s; s.dist_child({}, {!r}, {!r})"
        env = dict(os.environ, PYTHONPATH=here)
        procs = [subprocess.Popen(
            [sys.executable, "-c", code.format(
                r, init, os.path.join(d, f"rank{r}.pkl"))], cwd=here,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=DIST_JOIN_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                fail(f"world-2 rank {r} exited {p.returncode}:\n{log[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0, r1 = ranks
    same = all(np.array_equal(r0[k], r1[k]) for k in ("traj",)) and \
        np.array_equal(r0["pg"]["t"], r1["pg"]["t"]) and \
        np.array_equal(r0["pg"]["q"], r1["pg"]["q"])
    ref = c.dist_ref
    d_w1 = float(np.abs(r0["traj"][:, 1:4] - ref["traj"][:, 1:4]).max())
    d_dense = float(np.abs(r0["traj"][:, 1:4] - ref["dense"][:, 1:4]).max())
    # the shards' points of both maps against the dense maps'
    total = sum(r0["local"]) + sum(r1["local"])
    dense_pts = sum(ref["dense_points"])
    n = DIST_FRAMES
    want_c = {k: v * n for k, v in DIST_FRAME_COLLECTIVES.items()}
    say(f"distribution (b) world 2 on one card (gloo, two processes): ranks "
        f"bit-equal on every pose: {same}; max |dt| against world 1 "
        f"{d_w1:.2e} m and against the dense frame {d_dense:.2e} m (bound "
        f"5e-3); points (corner, surface) {r0['local']} + {r1['local']} = "
        f"{total} (dense {ref['dense_points']}, {dense_pts}; bound 0.5%); "
        f"{n} frames in {r0['wall']:.2f} s "
        f"wall on rank 0; launches a rank {nonzero(r0['launches'])}; "
        f"collectives {r0['collectives']}")
    if not same or d_w1 > 5e-3 or d_dense > 5e-3 or \
            abs(total - dense_pts) > max(5, 0.005 * dense_pts) or \
            r0["collectives"] != want_c:
        fail("world-2 sharded pipeline out of bounds")
    pg = r0["pg"]
    rt, rq = c.dist_pg_ref
    n = PG_KITTI_N                        # the real poses, as (d) at world 1
    worst = float(max(np.abs(pg["t"][:n] - rt[:n]).max(),
                      np.abs(pg["q"][:n] - rq[:n]).max()))
    want = dict({k: 0 for k in c.kernels.LAUNCHES},
                **{k: 10 * v for k, v in DIST_PG_LAUNCHES.items()})
    want_c = {k: 10 * v for k, v in DIST_PG_COLLECTIVES.items()}
    say(f"distribution (d) optimize_with_loops_distributed, world 2 (gloo), "
        f"N={PG_KITTI_N} padded to {len(rt)}, 10 iterations: "
        f"{pg['wall'] * 1e3:.1f} ms wall on rank 0; max |dpose| against "
        f"optimize_with_loops over the real poses {worst:.2e} (bound 1e-3); "
        f"per GN iteration "
        f"{nonzero({k: v / 10 for k, v in pg['launches'].items()})} launches "
        f"a rank, {({k: v / 10 for k, v in pg['collectives'].items()})} "
        f"collectives")
    if worst > 1e-3 or pg["launches"] != want or pg["collectives"] != want_c:
        fail("world-2 distributed pose graph out of bounds")


def dist_phase(c, rows):
    """Phase 10; returns (d)'s world-1 launches (the condense and
    back-substitute rows' main path)."""
    dist_namespace(c)
    c.runtime_pg.initialize(device="cuda")
    try:
        timed("distribution: (a) world 1", lambda: dist_world1_phase(c))
        timed("distribution: (c) sharded LIO", lambda: dist_lio_phase(c))
        launches = timed("distribution: (d) pose graph, world 1",
                         lambda: dist_pg_phase(c, rows))
        timed("distribution: (e) apps", lambda: dist_apps_phase(c))
    finally:
        c.runtime_pg.shutdown()
    timed("distribution: (b), (d) world 2", lambda: dist_world2_phase(c))
    return launches


# ----------------------------------------------------------------- main
def namespace(torch):
    """Import the port and return the namespace every phase reads, with
    the shipping configs (nothing built, nothing printed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from msf_loam_tpu_torch import kernels
    from msf_loam_tpu_torch.config import (FeatureConfig, ImuConfig,
                                           MappingConfig, MsfLoamConfig,
                                           OdometryConfig)
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.imu import deskew as deskew_mod
    from msf_loam_tpu_torch.imu import imu_factor as imu_factor_mod
    from msf_loam_tpu_torch.imu import preintegration as preint_mod
    from msf_loam_tpu_torch.ops import features, odo_corr as oc
    from msf_loam_tpu_torch.ops import pallas_knn as kn
    from msf_loam_tpu_torch.ops import pick_rounds as pr
    from msf_loam_tpu_torch.ops import select_fit as sf
    from msf_loam_tpu_torch.core import se3
    from msf_loam_tpu_torch.core.pointcloud import RingImage
    from msf_loam_tpu_torch.ops import block_tridiag as bt
    from msf_loam_tpu_torch.slam import batch_pipeline as bp
    from msf_loam_tpu_torch.slam import mapping, odometry
    from msf_loam_tpu_torch.slam import pipeline as pipe_mod
    from msf_loam_tpu_torch.slam import voxel_map as vm
    from msf_loam_tpu_torch.slam import loop_closure as lc
    from msf_loam_tpu_torch.slam import posegraph as pg
    from msf_loam_tpu_torch.slam import scan_context as sc
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline, ate_rmse
    from msf_loam_tpu_torch import proto, runtime
    from msf_loam_tpu_torch.apps import (calib_lidar_imu, evaluate,
                                         export_viz, kitti_to_bag,
                                         rosbag_to_npz, run_slam)
    from msf_loam_tpu_torch.dataio import (artifacts, kitti, npz_bag,
                                           nsh_bag, rosbag, stream)

    c = types.SimpleNamespace(
        torch=torch, kernels=kernels, FeatureConfig=FeatureConfig,
        ImuConfig=ImuConfig, MappingConfig=MappingConfig,
        MsfLoamConfig=MsfLoamConfig, OdometryConfig=OdometryConfig,
        preprocess=preprocess,
        synthetic=synthetic, deskew_mod=deskew_mod,
        imu_factor_mod=imu_factor_mod, preint_mod=preint_mod,
        features=features, oc=oc, kn=kn, pr=pr, sf=sf, mapping=mapping,
        odometry=odometry, pipe_mod=pipe_mod, vm=vm,
        SlamPipeline=SlamPipeline, ate_rmse=ate_rmse, bp=bp,
        RingImage=RingImage, bt=bt, pg=pg, sc=sc, lc=lc, se3=se3,
        Pose=se3.Pose, dev=torch.device("cuda"), proto=proto,
        runtime=runtime, run_slam=run_slam, app_evaluate=evaluate,
        app_export_viz=export_viz, app_calib=calib_lidar_imu,
        app_kitti_to_bag=kitti_to_bag, app_rosbag_to_npz=rosbag_to_npz,
        artifacts=artifacts, kitti=kitti, npz_bag=npz_bag, nsh_bag=nsh_bag,
        rosbag=rosbag, stream=stream)
    c.cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=2048, max_less_flat=8192),
        mapping=MappingConfig(map_table_size=1 << 15, map_cell_capacity=32,
                              max_query_points=4096,
                              max_corner_query_points=1024))
    # bench.py's LIO configuration; init_frames / warmup_msgs cut the run's
    # length (the defaults 50 / 100 would leave the drive uninitialised)
    c.lio_cfg = MsfLoamConfig(
        features=c.cfg.features, mapping=c.cfg.mapping,
        imu=ImuConfig(tight_coupling=True, init_frames=6, warmup_msgs=10,
                      max_imu_samples=64))
    c.bench_world = synthetic.World.corridor(seed=0, size=14.0)
    # apps/run_slam.py --selftest: the default config, 2048-point rings
    c.sim_cfg = MsfLoamConfig(features=FeatureConfig(max_points_per_ring=2048))
    c.lio_world = synthetic.World.corridor(seed=0, size=12.0)
    return c


def setup(torch):
    """The namespace (``namespace``), the card printed and the kernels
    built (phase 1)."""
    c = namespace(torch)
    kernels = c.kernels
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
    except FileNotFoundError:
        smi = []
    global CARD
    card = CARD = smi[0] if smi else CARD
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    c.sm_clock_mhz = float(clk.stdout.split()[0])
    say(f"maximum SM clock {c.sm_clock_mhz:.0f} MHz (nvidia-smi)")

    # ---- 1. build
    t0 = time.perf_counter()
    kernels.build_all()
    say(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(kernels.SOURCES)}")
    for name, log in kernels.BUILD_LOG.items():
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                               log))
        smem = [int(x) for x in re.findall(r"(\d+) bytes smem", log)]
        say(f"  ptxas {name}: {len(regs)} kernel(s), {min(regs, default=0)}"
              f"-{max(regs, default=0)} registers, {spill} bytes spilled, "
              f"shared memory up to {max(smem, default=0)} bytes")
        if name in ("select_fit", "knn"):
            say(f"    per instantiation <{'G,P' if name == 'select_fit' else 'list,R'}>"
                f" (registers, spill bytes, shared bytes): " + "; ".join(
                    f"<{t}> {r}, {sp}, {sm}"
                    for t, r, sp, sm in ptxas_entries(log)))
    return c


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    c = setup(torch)
    timed("fixtures", lambda: build_fixtures(c))
    return run_phases(c, t_start)


def run_phases(c, t_start):
    torch, kernels, card = c.torch, c.kernels, CARD
    # ---- 2. kernels against their plain versions
    rows, batch_rows = {}, {}
    say("kernels against their plain versions:")
    timed("kernels, lidar frame", lambda: lidar_kernel_phase(c, rows))
    timed("kernels, LIO planar pairs",
          lambda: lio_select_capture_phase(c, rows["select_fit"]))
    err64 = timed("kernels, 64 rings", lambda: ring64_phase(c))
    rows["select_fit"].v["err"] = max(rows["select_fit"].v["err"], err64)
    timed("kernels, batched frame", lambda: batch_kernel_phase(c, batch_rows))
    # ---- 3. the knn path
    knn_launches = timed("knn", lambda: knn_phase(c, rows))
    # ---- 4. the lidar-only main path
    lidar_launches = timed("lidar path", lambda: lidar_path_phase(c))
    # ---- 5. the LIO path
    timed("LIO accuracy", lambda: lio_accuracy_phase(c))
    lio_launches = timed("LIO speed", lambda: lio_speed_phase(c))
    # ---- 6. the batched multi-sequence path
    batch_launches = timed("batched path", lambda: batch_path_phase(c))
    # ---- 7. pose graph and loop closure
    rows["block_tridiag"] = Row()
    timed("pose graph and loop closure",
          lambda: posegraph_phase(c, rows["block_tridiag"]))
    # ---- 8. the odometry switches, checkpoint, stage timers
    switch_launches = timed("odometry switches", lambda: switch_phase(c))
    # ---- 9. ingest and the apps: the main path, run_slam
    app_launches, fusion_launches = timed("ingest and the apps",
                                          lambda: app_phase(c))
    # ---- 10. the distribution layer
    dist_launches = timed("distribution", lambda: dist_phase(c, rows))

    launches = dict(app_launches, knn=knn_launches,
                    **{k: dist_launches[k] for k in SPLIT})
    say(f"launches: 64-ring KITTI-format run_slam (the main path) "
          f"{app_launches}, LIO speed run {lio_launches}, lidar speed run "
          f"{lidar_launches}, knn path {knn_launches}, batched B={BATCH_B} "
          f"speed run {batch_launches}, block_tridiag on run_slam's five "
          f"--selftest shutdown fusions {fusion_launches}; per frame with "
          f"the switches: lidar motion_deskew {switch_launches['lidar'][1]}, "
          f"deskew + triangle {switch_launches['matcher'][1]}, batched "
          f"motion_deskew {switch_launches['batched'][1]}")

    def entry(name, label, o, n):
        if n <= 0:
            fail(f"{label} was never launched on its path")
        return dict(
            name=label, route="cuda",
            source=f"msf_loam_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES.get(label, REPLACES[name]), launches=n,
            max_abs_err=o["max_abs_err"], ms=o["ms"], plain_ms=o["plain_ms"],
            bound_ms=o["bound_ms"], bound_by=o["bound_by"],
            library_ms=o["library_ms"], device_ms=o["device_ms"],
            batch_ms=o["batch_ms"], device_from=o["device_from"])
    kern = [entry(name, name, rows[name].out(), launches[name])
            for name in kernels.SOURCES]
    kern += [entry("block_tridiag", name, rows[name].out(), launches[name])
             for name in SPLIT]
    kern += [entry(name, f"{name} (batched B={BATCH_B})",
                   batch_rows[name].out(), batch_launches[name])
             for name in ("pick_rounds", "odo_corr", "select_fit")]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
