#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (msf_loam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. build the four hand-written CUDA kernels from ``msf_loam_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. kernels against their plain PyTorch versions on the card:
   * pick_rounds, odo_corr, select_fit on every call of one real frame of
     the full-width lidar-only pipeline (16 rings x 1800 points, 32k-slot
     maps); pick_rounds bit-equal; odo_corr indices and rings exact, d2
     bit-equal; select_fit d2 within 1e-5 relative, centres within 1e-4
     m, normals within 1e-4 of parallel, validity equal except where a
     plain gate value lies within 1e-5 (relative) of its threshold;
   * seeded adversarial cases, bit-equal: pick_rounds at the frame's
     (16, 2048) with signed zeros, exact ties, interleaved sector ids, an
     empty sector, sectors with fewer valid columns than 6, suppression
     across sector edges with a broken gap chain; odo_corr at K=0 and
     K=16 with duplicates across the kernel's slice edges, an
     all-sentinel slice, rows with no nearby-ring partner and ragged N;
     select_fit rows cases with ties;
   * select_fit on the planar (3, Q, 8P) calls of one real
     pre-initialisation LIO frame (the one-level mapping gather), same
     tolerances;
   * pick_rounds and odo_corr on the calls of a 64-ring frame (bench.py's
     MSF_BENCH_RINGS=64 configuration: (64, 2048) planes, edge N=768
     M=7680, plane N=1536 M=8192) and the seeded pick cases at (64, 2048);
   * knn at scripts/bench_knn.py's shapes (Q=4096, M=65536, k=8 and k=5,
     10% of the refs masked) and on seeded cases (fewer valid refs than k,
     duplicated refs, ragged Q and M): d2 bit-equal, indices equal;
   per kernel and call site the event time (median of 50 launches around
   the wrapper), the device-only time (torch.profiler kernel time over 50
   launches; a batch of 50 back-to-back launches between one event pair
   beside it), the plain version's time, for knn the library yardstick
   (cdist + masked fill + topk), the bound max(bytes / 3.35 TB/s,
   operations / 67 TFLOP/s), and for pick_rounds and odo_corr the launch
   (clusters, blocks, threads, shared memory; registers and spills come
   from the ptxas lines of the build);
3. the knn path: its entry point ``knn_auto`` at both bench shapes, with
   launches counted around it;
4. the lidar-only main path through ``SlamPipeline(cfg, device="cuda")``:
   accuracy (10 frames of the tests/test_pipeline.py corridor drive, ATE
   < 0.05 m), the first 3 frames again with ``device="cpu"`` (plain
   versions; mapped poses within 1e-3 m / 1e-3), speed over 30 distinct
   frames of the bench.py drive with launches counted (1 pick_rounds + 4
   odo_corr + 6 select_fit per frame, one extra pick_rounds on the first
   frame), host-clock stage times over 5 frames and a profile of 3;
5. the LIO path through ``SlamPipeline.add_imu`` + ``process_ring_image``
   on tests/test_lio_pipeline.py's distorted corridor drive (V0 = (1.2,
   0.4, 0) m/s, 0.25 rad/s yaw, 400 Hz IMU, init_frames=6,
   warmup_msgs=10): accuracy over 9 frames with tight_coupling off and on
   (ATE < 0.15 m each); 3 post-init frames again with ``device="cpu"``
   from the card's state (mapped poses within 1e-3 m / 1e-3, velocity
   within 1e-2 m/s); speed over 30 distinct frames at full width (the
   bench.py LIO configuration, tight coupling, ~40-sample IMU windows)
   with launches counted per frame (1 pick_rounds + 4 odo_corr + 6
   select_fit on every post-init frame), host-clock time per LIO stage
   over 5 frames, and a torch.profiler trace of 3 post-init frames.

Prints, before the last line, a ``{"kernels": [...]}`` JSON line and the
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
LIO_FRAMES, LIO_STAGE_FRAMES, LIO_PROFILE_FRAMES = 30, 5, 3
LIDAR_FRAMES = 30

REPLACES = {
    "pick_rounds": "msf_loam_tpu/ops/pick_rounds.py:138",
    "odo_corr": "msf_loam_tpu/ops/odo_corr.py:152",
    "select_fit": "msf_loam_tpu/ops/select_fit.py:276",
    "knn": "msf_loam_tpu/ops/pallas_knn.py:102",
}
DEVICE_KERNEL = {"pick_rounds": "pick_rounds_kernel",
                 "odo_corr": "odo_corr_kernel",
                 "select_fit": "select_fit_kernel", "knn": "knn_"}


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
    """Device time per call of the kernels whose names hold ``key``, from a
    torch.profiler trace of ``reps`` calls; None if the trace has none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(self_dev_us(e) for e in device_events(prof) if key in e.key)
    return us / 1e3 / reps if us > 0 else None


def kernel_times(torch, name, fn, plain_fn, plain_reps=10):
    """Event ms, device-only ms (profiler, else the batch), batch ms and
    plain ms of one call site."""
    t = dict(ms=cuda_ms(torch, fn), batch_ms=batch_ms(torch, fn),
             plain_ms=cuda_ms(torch, plain_fn, reps=plain_reps))
    dev = device_only_ms(torch, fn, DEVICE_KERNEL[name])
    t["device_ms"] = dev if dev is not None else t["batch_ms"]
    t["device_from"] = "profiler" if dev is not None else "batch"
    return t


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
            f"ms ({t['device_from']}; batch {t['batch_ms']:.4f}), plain "
            f"{t['plain_ms']:.3f} ms")


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


def odo_work(N, M, K):
    """(bytes, operations) of one odo_corr call."""
    return N * 12 + M * 16 + N * (5 + 3 * K) * 4, N * M * 15


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
    N, M = q.shape[0], planes.shape[1]
    t = kernel_times(torch, "odo_corr",
                     lambda: oc.odo_corr_planes(q, planes, K, nb),
                     lambda: oc.odo_corr_plain(q, planes, K, nb))
    b, by = bound_ms(*odo_work(N, M, K))
    g = oc.launch_geometry(N, M, K)
    say(f"  odo_corr K={K} N={N} M={M}: {fmt(t)}, bound {b:.5f} ms ({by}); "
        f"{g['blocks']} blocks in clusters of {g['cluster']}, 256 threads, "
        f"{g['smem']} B dynamic shared memory")
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


def check_select(torch, sf, cand, q, r2s, r2w, kw, tag):
    got = sf.select_fit(cand, q, r2s, r2w, **kw)
    x, y, z, g, want = plain_select(sf, cand, q, r2s, r2w, kw)
    fin = want.d2 < 1e37
    if not torch.equal(got.d2 >= 1e37, ~fin):
        fail(f"select_fit {tag}: the in-radius sets differ")
    rel = ((got.d2 - want.d2).abs() / want.d2.abs().clamp(min=1e-30))[fin]
    if rel.numel() and float(rel.max()) > 1e-5:
        fail(f"select_fit {tag}: d2 off by {float(rel.max())} relative")
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


def select_site(torch, sf, row, cand, q, r2s, r2w, kw, tag):
    """Check one select_fit call site, time it and add it to ``row``."""
    q = q.contiguous()
    row.v["err"] = max(row.v["err"], check_select(torch, sf, cand, q, r2s,
                                                  r2w, kw, tag))
    t = kernel_times(torch, "select_fit",
                     lambda: sf.select_fit(cand, q, r2s, r2w, **kw),
                     lambda: plain_select(sf, cand, q, r2s, r2w, kw))
    N = q.shape[0]
    C = cand.numel() // (3 * N)
    k = kw["k"]
    nbytes = cand.numel() * 4 + N * 12 + N * (k + 7) * 4
    nops = N * C * ({"line": 40, "plane": 50, "plane2": 90}[kw["mode"]] + k)
    b, by = bound_ms(nbytes, nops)
    say(f"  select_fit {kw['mode']} {tuple(cand.shape)}: {fmt(t)}, bound "
          f"{b:.5f} ms ({by})")
    row.add(t, nbytes, nops)


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
        return
    say(f"profile {label}: {wall * 1e3:.1f} ms wall (traced), device busy "
          f"{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
          f"{sum(e.count for e in evs)} kernel launches")
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


def capture_frame(c, cfg, n_rings, patches):
    """The kernel calls of the third frame of the bench drive through the
    lidar-only pipeline: ``patches`` are (module, attribute, wrapper)
    triples; returns each attribute's calls as (cloned args, kwargs)."""
    torch = c.torch
    calls = {attr: [] for _, attr, _ in patches}

    def recorder(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((tuple(t.clone() if torch.is_tensor(t) else t
                                      for t in a), dict(kw)))
            return fn(*a, **kw)
        return wrapped

    imgs = images(c.synthetic, c.preprocess, cfg.features, c.bench_world,
                  bench_drive(3), 0.004, lambda i: 100 + i, c.dev,
                  n_rings=n_rings)
    pipe = c.SlamPipeline(cfg, device="cuda")
    for img in imgs[:2]:
        pipe.process_ring_image(img, 0.0)
    for mod, attr, fn in patches:
        setattr(mod, attr, recorder(attr, fn))
    try:
        pipe.process_ring_image(imgs[2], 0.2)
    finally:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    return calls


def lidar_kernel_phase(c, rows):
    """Capture one real lidar-only frame's kernel calls and hold each kernel
    to its plain version (plus seeded tie / sentinel cases)."""
    torch, pr, oc, sf = c.torch, c.pr, c.oc, c.sf
    calls = capture_frame(c, c.cfg, 16, [
        (c.features, "pick_rounds", pr.pick_rounds),
        (c.odometry, "odo_corr", oc.odo_corr),
        (c.odometry, "select_fit", sf.select_fit),
        (c.mapping, "select_fit", sf.select_fit)])
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"pick_rounds": 1, "odo_corr": 4, "select_fit": 6}:
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
        row.add(t, *odo_work(q.shape[0], planes.shape[1], K))
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

    # select_fit: the frame's 6 calls + seeded rows cases with ties
    row = rows["select_fit"] = Row()
    for i, (a, kw) in enumerate(calls["select_fit"]):
        cand, q, r2s, r2w = a
        select_site(torch, sf, row, cand, q, r2s, r2w, kw,
                    f"call {i} {kw.get('mode')}")
    N, C = 1024, 256
    qn = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    off = rng.uniform(-1.5, 1.5, (N, C, 3)).astype(np.float32)
    off[:, 128:160] = off[:, 0:32]                      # duplicate distances
    off[:, :, 2] *= 0.02                                # near-planar
    cnd = qn[:, None, :] + off
    cnd[rng.uniform(size=(N, C)) < 0.2] = 1e9           # empty-slab sentinel
    cnd = np.transpose(cnd, (0, 2, 1)).reshape(N, 3 * C)
    for mode in ("line", "plane2"):
        row.v["err"] = max(row.v["err"], check_select(
            torch, sf, torch.from_numpy(np.ascontiguousarray(cnd)).to(dev),
            torch.from_numpy(qn).to(dev), 1.0, 4.0,
            dict(k=5, mode=mode, min_count=5, min_wide=5), f"seeded {mode}"))


def ring64_phase(c):
    """pick_rounds and odo_corr at the 64-ring shapes (bench.py's
    MSF_BENCH_RINGS=64 configuration): the calls of the third frame of the
    bench drive at 64 rings, held bit-equal to the plain versions and
    timed, and the seeded pick cases at (64, 2048)."""
    torch, pr, oc = c.torch, c.pr, c.oc
    cfg = c.MsfLoamConfig(
        features=c.cfg.features,
        mapping=c.MappingConfig(map_table_size=1 << 15, map_cell_capacity=32,
                                max_query_points=4096,
                                max_corner_query_points=2048))
    calls = capture_frame(c, cfg, 64, [
        (c.features, "pick_rounds", pr.pick_rounds),
        (c.odometry, "odo_corr", oc.odo_corr)])
    if [len(calls["pick_rounds"]), len(calls["odo_corr"])] != [1, 4]:
        fail(f"64-ring frame: captured {calls}")
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
        say(f"  knn Q={KNN_Q} M={KNN_M} k={k}: {fmt(t)}, library (cdist + "
              f"masked fill + topk) {t_lib:.4f} ms (its d^2 within {yard:.1e} "
              f"relative), bound {b:.5f} ms ({by})")
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
            "select_fit": 6 * n_frames, "knn": 0}
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
    """The planar (3, Q, 8P) select_fit calls of one real pre-init LIO frame
    at full width, held to the plain version."""
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
        return sf.select_fit(*a, **kw)

    c.mapping.select_fit = rec
    try:
        pipe.process_ring_image(imgs[2], LIO_T0 + 0.2)
    finally:
        c.mapping.select_fit = sf.select_fit
    torch.cuda.synchronize()
    if len(calls) != 4 or any(a[0].dim() != 3 for a, _ in calls):
        fail(f"pre-init LIO frame: {len(calls)} mapping select_fit calls, "
             f"shapes {[tuple(a[0].shape) for a, _ in calls]}")
    sub = Row()
    for i, (a, kw) in enumerate(calls):
        cand, q, r2s, r2w = a
        select_site(torch, sf, sub, cand, q, r2s, r2w, kw,
                    f"lio pre-init mapping call {i} {kw.get('mode')}")
    row.v["err"] = max(row.v["err"], sub.v["err"])
    o = sub.out()
    say(f"  select_fit planar mapping calls per pre-init frame: event "
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
    """30 distinct frames at full width (tight coupling), launches per
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
    want = {"pick_rounds": 1, "odo_corr": 4, "select_fit": 6, "knn": 0}
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
    from msf_loam_tpu_torch.slam import mapping, odometry
    from msf_loam_tpu_torch.slam import pipeline as pipe_mod
    from msf_loam_tpu_torch.slam import voxel_map as vm
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline, ate_rmse

    c = types.SimpleNamespace(
        torch=torch, kernels=kernels, FeatureConfig=FeatureConfig,
        ImuConfig=ImuConfig, MappingConfig=MappingConfig,
        MsfLoamConfig=MsfLoamConfig, preprocess=preprocess,
        synthetic=synthetic, deskew_mod=deskew_mod,
        imu_factor_mod=imu_factor_mod, preint_mod=preint_mod,
        features=features, oc=oc, kn=kn, pr=pr, sf=sf, mapping=mapping,
        odometry=odometry, pipe_mod=pipe_mod, vm=vm,
        SlamPipeline=SlamPipeline, ate_rmse=ate_rmse,
        dev=torch.device("cuda"))
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
    c.lio_world = synthetic.World.corridor(seed=0, size=12.0)

    # ---- 2. kernels against their plain versions
    rows = {}
    say("kernels against their plain versions:")
    lidar_kernel_phase(c, rows)
    lio_select_capture_phase(c, rows["select_fit"])
    ring64_phase(c)
    # ---- 3. the knn path
    knn_launches = knn_phase(c, rows)
    # ---- 4. the lidar-only main path
    lidar_launches = lidar_path_phase(c)
    # ---- 5. the LIO path
    lio_accuracy_phase(c)
    lio_launches = lio_speed_phase(c)

    launches = dict(lio_launches, knn=knn_launches)
    say(f"launches: LIO speed run {lio_launches}, lidar speed run "
          f"{lidar_launches}, knn path {knn_launches}")
    kern = []
    for name in kernels.SOURCES:
        o = rows[name].out()
        kern.append(dict(
            name=name, route="cuda", source=f"msf_loam_tpu_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=o["max_abs_err"], ms=o["ms"], plain_ms=o["plain_ms"],
            bound_ms=o["bound_ms"], bound_by=o["bound_by"],
            library_ms=o["library_ms"], device_ms=o["device_ms"],
            batch_ms=o["batch_ms"], device_from=o["device_from"]))
        if launches[name] <= 0:
            fail(f"{name} was never launched on its path")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
