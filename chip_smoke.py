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
   (a) the kernel bit-equal to its plain version on seeded SPD systems at
   N = 20 and 64 with m = 1 and 49 right-hand sides, and on the first
   Gauss-Newton system with loops of (c) (N = 8192, m = 49: one call of the
   plain version, timed); event, device-only and batch times at N = 8192,
   m = 1 and 49, launch geometry, the bound, and the dense
   torch.linalg.solve of the assembled 6N x 6N system as the library
   yardstick (median of 3 at N = 1024, one call at N = 8192);
   (b) apps/run_slam.py's shutdown fusion on the port at full width (its
   --selftest drive: default config, 16 rings x 1800 points, keyframes
   every loop_keyframe_stride frames): the 30-frame out-and-back drive
   with proximity detection + scan matcher (>= 1 loop edge, ATE < 0.08 m,
   odo_corr, select_fit and block_tridiag launched by the loop-closure
   step), scan context + scan matcher and proximity + submap matcher
   (ATE < 0.08 m), --sim_gps --posegraph (ATE < 0.1 m), and the 25-frame
   straight drive (0 edges, ATE < 0.08 m); one block_tridiag launch per
   Gauss-Newton iteration on each;
   (c) a graph at KITTI-00 size (4541 poses padded to 8192: a square
   driven twice with a 1e-4 rad yaw bias a pose, GPS every 10th pose with
   U(-5, 5) cm noise, 8 loop factors from ground truth): optimize and
   optimize_with_loops, 10 iterations each (finite poses, falling cost),
   their wall times and errors, host-clock stages and a profile;
   (d) (c)'s problem at N = 64 with ``device="cpu"`` against the card
   (poses within 1e-3).

Prints, before the last line, a ``{"kernels": [...]}`` JSON line (the
batched frame's call sites as rows of their own) and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Runs only where
``torch.cuda.is_available()``; imports nothing of JAX.
"""

import json
import os
import re
import subprocess
import sys
import time
import types

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
                     "(lax.scan)",
}
DEVICE_KERNEL = {"pick_rounds": "pick_rounds_kernel",
                 "odo_corr": "odo_corr_kernel",
                 "select_fit": "select_fit_kernel", "knn": "knn_",
                 "block_tridiag": "block_tridiag_kernel"}


CARD = "nvidia-smi unavailable"   # name, power limit; set by main()


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
            "select_fit": 4 * n_frames, "knn": 0, "block_tridiag": 0}
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
            "block_tridiag": 0}
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


def batch_drive_images(c, B, T, step_of, fcfg, device):
    """tests/test_batch_pipeline.py: lane b in World.corridor(seed=b),
    straight steps ``step_of(b)`` a frame; (T, B) images and (B, T, 3)
    ground truth."""
    frames = [[None] * B for _ in range(T)]
    gts = np.zeros((B, T, 3))
    for b in range(B):
        world = c.synthetic.World.corridor(seed=b, size=12.0)
        for i in range(T):
            t = step_of(b) * i
            xyz, ring = c.synthetic.simulate_scan(
                world, t, np.eye(3), n_rings=16, pts_per_ring=900,
                noise=0.004, seed=10 * b + i)
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
            "knn": 0, "block_tridiag": 0}
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


def tridiag_work(N, m):
    """(bytes, float operations) of one block-Thomas solve: D, U and B read
    once and X written once; per step the 6x6 factorisation, the six
    columns of Dt⁻¹U, the 6 x (6+m) update and the m backward columns."""
    nbytes = 4 * (36 * N + 36 * (N - 1) + 2 * 6 * m * N)
    factor = sum(2 * (5 - k) * (6 - k) for k in range(6))
    solve_col = 2 * 15 + 6 + 2 * 15
    ops = N * (factor + 6 * solve_col + 12 * 6 * (6 + m)
               + m * (12 * 6 + solve_col))
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


def check_tridiag(torch, bt, D, U, B, tag):
    """The plain version's solution, after holding the kernel to it."""
    want = bt.block_tridiag_plain(D, U, B)
    torch.cuda.synchronize()
    got = bt.block_tridiag(D, U, B)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"block_tridiag {tag}: non-finite solution")
    if not torch.equal(got, want):
        fail(f"block_tridiag {tag}: differs from its plain version by "
             f"{float((got - want).abs().max())}")
    return want


def posegraph_kernel_phase(c, row, system):
    """block_tridiag against its plain version (bit-equal) on seeded SPD
    systems and on the KITTI-size graph's first GN system with loops, its
    times, launch geometry, bound and the dense-solve yardstick."""
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
                f"|H x - b| {float(res):.2e} (float64 residual)")
    D, U, B = system
    N, m = B.shape[0], B.shape[2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check_tridiag(torch, bt, D, U, B, f"KITTI-size first GN system N={N} "
                  f"m={m}")
    plain_ms = (time.perf_counter() - t0) * 1e3    # one plain call
    say(f"block_tridiag KITTI-size first GN system with loops (N={N}, "
        f"m={m}): bit-equal to its plain version")
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
        nbytes, nops = tridiag_work(N, mm)
        b, by = bound_ms(nbytes, nops)
        say(f"block_tridiag N={N} m={mm}: kernel {t['ms']:.3f} ms (events), "
            f"device {t['device_ms']:.3f} ms ({t['device_from']}; batch "
            f"{t['batch_ms']:.3f}), {t['device_ms'] / N / 2 * 1e3:.2f} us a "
            f"block step; bound {b * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} "
            f"MB, {nops / 1e6:.1f} Mflop; the 2N dependent 6x6 steps bound "
            f"it in practice); launch {bt.launch_geometry(mm)}")
        if mm == m:
            row.add(t, nbytes, nops)
    say(f"block_tridiag plain version, one call at N={N} m={m}: "
        f"{plain_ms:.1f} ms")
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


def slam_drive(c, path, n):
    """run_slam's selftest drive through the port (default config, 16 rings
    x 1800 points, World.corridor(seed=0, size=12.0)): ``loop`` goes out and
    back, ``straight`` drifts gently. Returns (trajectory, keyframes,
    ground truth, GPS times and fixes as run_slam's --sim_gps draws them)."""
    cfg = c.sim_cfg
    world = c.synthetic.World.corridor(seed=0, size=12.0)
    pipe = c.SlamPipeline(cfg, device="cuda")
    rng = np.random.default_rng(0)
    keyframes, gt, gps_t, gps_xyz = {}, [], [], []
    pg_cfg = cfg.posegraph
    for i in range(n):
        if path == "loop":
            fwd = i if i < n // 2 else (n - 1 - i)
            t, yaw = np.array([0.25 * fwd, 0.0, 0.0]), 0.0
        else:
            t, yaw = np.array([0.25 * i, 0.1 * np.sin(0.2 * i), 0.0]), 0.02 * i
        cy, sy = np.cos(yaw), np.sin(yaw)
        R = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        xyz, ring = c.synthetic.simulate_scan(world, t, R, n_rings=16,
                                              pts_per_ring=1800, noise=0.004,
                                              seed=i)
        img = c.preprocess.preprocess_scan(xyz, ring, cfg.features, 16,
                                           device=c.dev)
        pipe.process_ring_image(img, 0.1 * i)
        idx = len(pipe.results) - 1
        if idx % pg_cfg.loop_keyframe_stride == 0:
            keyframes[idx] = pipe.prev_scan
        gt.append(t)
        if i % pg_cfg.sim_gps_period == 0:
            gps_t.append(0.1 * i)
            gps_xyz.append(t + rng.uniform(-pg_cfg.sim_gps_noise,
                                           pg_cfg.sim_gps_noise, 3))
    return pipe.trajectory(), keyframes, np.asarray(gt), gps_t, gps_xyz


def close_loops(c, poses, data, traj, keyframes, detector, edge_matcher):
    """apps/run_slam.py:_close_loops on the port: detect revisits among the
    keyframes, scan-match each candidate into a loop edge, solve the pose
    graph with the edges folded in. Returns (result, edges, candidates)."""
    torch, Pose, cfg = c.torch, c.Pose, c.sim_cfg
    pgc = cfg.posegraph
    kf_idx = sorted(keyframes)
    stride = max(1, pgc.loop_keyframe_stride)
    gap_kf = max(1, pgc.loop_min_index_gap // stride)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=c.dev)
    guesses = {}
    if detector == "scan_context":
        descs = torch.stack([c.sc.compute_descriptor(
            keyframes[k].full.xyz, keyframes[k].full.mask) for k in kf_idx])
        triples = c.sc.detect_loops_scan_context(
            descs.cpu().numpy(), min_index_gap=gap_kf,
            max_dist=pgc.loop_sc_max_dist, max_loops=pgc.loop_max_count,
            suppress_gap=max(1, gap_kf // 2),
            prescreen=0 if len(kf_idx) < 100 else 25, device=c.dev)
        pairs = [(a, b) for a, b, _ in triples]
        for a, b, yaw in triples:
            guesses[(a, b)] = Pose(T(np.zeros(3)), c.se3.quat_exp(
                T([0.0, 0.0, yaw])))
    else:
        pairs = c.lc.detect_loops(
            traj[kf_idx, 1:4], max_dist=pgc.loop_max_dist,
            min_index_gap=gap_kf, max_loops=pgc.loop_max_count,
            suppress_gap=max(1, gap_kf // 2))
    graph = c.lc.SparsePoseGraph(pad_loops=pgc.loop_max_count)
    for a, b in pairs:
        fi, fj = kf_idx[a], kf_idx[b]
        pose_i = Pose(T(traj[fi, 1:4]), T(traj[fi, 4:8]))
        pose_j = Pose(T(traj[fj, 1:4]), T(traj[fj, 4:8]))
        if edge_matcher == "submap":
            guess = guesses.get((a, b))
            if guess is None:
                guess = pose_i.inverse().compose(pose_j)
            neighbors = []
            for fn_ in (fi - stride, fi, fi + stride):
                if fn_ in keyframes:
                    pose_n = Pose(T(traj[fn_, 1:4]), T(traj[fn_, 4:8]))
                    neighbors.append((keyframes[fn_],
                                      pose_i.inverse().compose(pose_n)))
            rel, ok = c.lc.match_loop_pair_submap(neighbors, keyframes[fj],
                                                  guess, cfg)
        else:
            rel, ok = c.lc.match_loop_pair(keyframes[fi], keyframes[fj],
                                           pose_i, pose_j, cfg,
                                           guess=guesses.get((a, b)))
        if bool(ok):
            graph.add_edge(c.lc.LoopEdge(fi, fj, rel.t.cpu().numpy(),
                                         rel.q.cpu().numpy()))
    out = graph.optimize(poses, data, pgc, n_iters=pgc.iterations)
    return out, [(e.frame_i, e.frame_j) for e in graph.edges], pairs


def shutdown_fusion(c, drive, mode):
    """run_slam's shutdown pose-graph fusion (apps/run_slam.py:453-487) on a
    finished drive: loop closure with a detector and an edge matcher, or
    the sim-GPS pose graph. Returns (summary, launches of the step)."""
    torch, Pose, pg, kernels = c.torch, c.Pose, c.pg, c.kernels
    traj, keyframes, gt, gps_t, gps_xyz = drive
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=c.dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    poses = Pose(T(traj[:, 1:4]), T(traj[:, 4:8]))
    if mode == "sim_gps":
        g_t, g_xyz = T(gps_t), T(gps_xyz)
        g_valid = torch.ones(len(gps_t), dtype=torch.bool, device=c.dev)
    else:                     # placeholder row; invalid, so inert
        g_t, g_xyz = T(np.zeros(1)), T(np.zeros((1, 3)))
        g_valid = torch.zeros(1, dtype=torch.bool, device=c.dev)
    data = pg.build_graph_data(T(traj[:, 0]), poses, g_t, g_xyz, g_valid)
    n_real = len(traj)
    poses, data = pg.pad_graph(poses, data, pg.next_bucket(n_real))
    edges = pairs = None
    if mode == "sim_gps":
        out = pg.optimize(poses, data, c.sim_cfg.posegraph,
                          n_iters=c.sim_cfg.posegraph.iterations)
    else:
        out, edges, pairs = close_loops(c, poses, data, traj, keyframes,
                                        *mode)
    fused = traj.copy()
    fused[:, 1:4] = out.poses.t[:n_real].cpu().numpy()
    fused[:, 4:8] = out.poses.q[:n_real].cpu().numpy()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    gt_rel = gt - gt[0]
    return dict(ate_before=c.ate_rmse(traj[:, 1:4], gt_rel),
                ate=c.ate_rmse(fused[:, 1:4], gt_rel),
                cost=(float(out.initial_cost), float(out.final_cost)),
                edges=edges, candidates=pairs, wall=wall,
                finite=bool(np.isfinite(fused).all())), launches


def shutdown_fusion_phase(c):
    """Phase 7(b): the out-and-back drive four ways and the straight drive;
    returns block_tridiag's launches over the five shutdown steps."""
    loop = slam_drive(c, "loop", 30)
    straight = slam_drive(c, "straight", 25)
    runs = [("out-and-back, proximity + scan matcher", loop,
             ("proximity", "scan"), 0.08),
            ("out-and-back, scan context + scan matcher", loop,
             ("scan_context", "scan"), 0.08),
            ("out-and-back, proximity + submap matcher", loop,
             ("proximity", "submap"), 0.08),
            ("out-and-back, --sim_gps --posegraph", loop, "sim_gps", 0.1),
            ("straight, proximity + scan matcher", straight,
             ("proximity", "scan"), 0.08)]
    total = 0
    for k, (label, drive, mode, bound) in enumerate(runs):
        s, launches = shutdown_fusion(c, drive, mode)
        total += launches["block_tridiag"]
        say(f"shutdown fusion, {label}: loop candidates (keyframe indices) "
            f"{s['candidates']}, edges accepted (frames) {s['edges']}; cost {s['cost'][0]:.6g} -> "
            f"{s['cost'][1]:.6g}; ATE {s['ate_before']:.5f} -> "
            f"{s['ate']:.5f} m (bound {bound} m); {s['wall']:.2f} s; "
            f"launches {launches}")
        if not s["finite"] or s["ate"] >= bound:
            fail(f"{label}: ATE {s['ate']} m")
        if launches["block_tridiag"] != c.sim_cfg.posegraph.iterations:
            fail(f"{label}: {launches['block_tridiag']} block_tridiag "
                 f"launches, one per GN iteration expected")
        if k == 0 and (len(s["edges"]) < 1 or launches["odo_corr"] < 1
                       or launches["select_fit"] < 1):
            fail(f"{label}: {len(s['edges'])} loop edges, launches "
                 f"{launches}")
        if k == 4 and s["edges"]:
            fail(f"{label}: {s['edges']} loop edges on a drive with no "
                 f"revisit")
    return total


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
    """Phase 7: pose graph and loop closure; returns block_tridiag's
    launches on the shutdown-fusion path."""
    prob = pg_problem(c, PG_KITTI_N, PG_LOOPS, c.dev)
    system = first_gn_system(c, *prob[1:], c.sim_cfg.posegraph)
    timed("pose graph: block_tridiag",
          lambda: posegraph_kernel_phase(c, row, system))
    del system
    launches = timed("pose graph: shutdown fusion",
                     lambda: shutdown_fusion_phase(c))
    timed("pose graph: KITTI-size graph", lambda: kitti_graph_phase(c, prob))
    timed("pose graph: CPU parity", lambda: pg_parity_phase(c))
    return launches


# ----------------------------------------------------------------- main
def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from msf_loam_tpu_torch import kernels
    from msf_loam_tpu_torch.config import (FeatureConfig, ImuConfig,
                                           MappingConfig, MsfLoamConfig)
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

    c = types.SimpleNamespace(
        torch=torch, kernels=kernels, FeatureConfig=FeatureConfig,
        ImuConfig=ImuConfig, MappingConfig=MappingConfig,
        MsfLoamConfig=MsfLoamConfig, preprocess=preprocess,
        synthetic=synthetic, deskew_mod=deskew_mod,
        imu_factor_mod=imu_factor_mod, preint_mod=preint_mod,
        features=features, oc=oc, kn=kn, pr=pr, sf=sf, mapping=mapping,
        odometry=odometry, pipe_mod=pipe_mod, vm=vm,
        SlamPipeline=SlamPipeline, ate_rmse=ate_rmse, bp=bp,
        RingImage=RingImage, bt=bt, pg=pg, sc=sc, lc=lc, se3=se3,
        Pose=se3.Pose, dev=torch.device("cuda"))
    t_start = time.perf_counter()
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
    pg_launches = timed("pose graph and loop closure",
                        lambda: posegraph_phase(c, rows["block_tridiag"]))

    launches = dict(lio_launches, knn=knn_launches,
                    block_tridiag=pg_launches)
    say(f"launches: LIO speed run {lio_launches}, lidar speed run "
          f"{lidar_launches}, knn path {knn_launches}, batched B={BATCH_B} "
          f"speed run {batch_launches}, block_tridiag on the shutdown "
          f"fusions {pg_launches}")

    def entry(name, label, o, n):
        if n <= 0:
            fail(f"{label} was never launched on its path")
        return dict(
            name=label, route="cuda",
            source=f"msf_loam_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=n,
            max_abs_err=o["max_abs_err"], ms=o["ms"], plain_ms=o["plain_ms"],
            bound_ms=o["bound_ms"], bound_by=o["bound_by"],
            library_ms=o["library_ms"], device_ms=o["device_ms"],
            batch_ms=o["batch_ms"], device_from=o["device_from"])
    kern = [entry(name, name, rows[name].out(), launches[name])
            for name in kernels.SOURCES]
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
