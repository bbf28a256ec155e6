#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (msf_loam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. build the three hand-written CUDA kernels from ``msf_loam_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel);
2. capture every kernel call of one real frame of the full-width pipeline
   (16 rings x 1800 points, 32k-slot maps), add a seeded numpy case per
   kernel with exact ties and sentinels, and hold each kernel against its
   plain PyTorch version on the card: pick_rounds bit-equal; odo_corr
   indices and rings exact, d2 within 1e-6 relative; select_fit d2 within
   1e-5 relative, centres within 1e-4 m, normals within 1e-4 of parallel,
   validity equal except where a plain gate value lies within 1e-5
   (relative) of its threshold. Times are medians of 50 launches (CUDA
   events); the bound is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s);
3. the main path through ``SlamPipeline(cfg, device="cuda")``:
   accuracy (10 frames of the tests/test_pipeline.py corridor drive, ATE
   < 0.05 m), the first 3 of those frames again with ``device="cpu"``
   (plain versions; mapped poses within 1e-3 m / 1e-3), and speed over 30
   distinct frames of the bench.py drive with the launch counts of every
   kernel read around that run (1 pick_rounds + 4 odo_corr + 6 select_fit
   per frame, one extra pick_rounds on the first frame);
4. where the time goes: host-clock time per stage over 5 frames (each
   stage synchronised), and a torch.profiler trace of 3 frames (device
   time by kernel, device busy share).

Prints, before the last line, a ``{"kernels": [...]}`` JSON line and the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Runs only where
``torch.cuda.is_available()``; imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
REPS = 50

REPLACES = {
    "pick_rounds": "msf_loam_tpu/ops/pick_rounds.py:138",
    "odo_corr": "msf_loam_tpu/ops/odo_corr.py:152",
    "select_fit": "msf_loam_tpu/ops/select_fit.py:276",
}


def fail(msg):
    raise RuntimeError(msg)


def cuda_ms(torch, fn, reps=REPS):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
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


def bound_ms(nbytes, nops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def images(synthetic, preprocess, fcfg, world, poses, noise, seed_of, device):
    imgs = []
    for i, (t, R) in enumerate(poses):
        xyz, ring = synthetic.simulate_scan(world, t, R, n_rings=16,
                                            pts_per_ring=1800, noise=noise,
                                            seed=seed_of(i))
        imgs.append(preprocess.preprocess_scan(xyz, ring, fcfg, num_rings=16,
                                               device=device))
    return imgs


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
        rel = ((g - w).abs() / w.abs().clamp(min=1e-30))
        if rel.numel() and float(rel.max()) > 1e-6:
            fail(f"odo_corr {tag}: {f} off by {float(rel.max())} relative")
        if g.numel():
            fin = w < 1e37
            err = max(err, float((g - w).abs()[fin].max()) if fin.any() else 0.0)
    return err


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
    print(f"  select_fit {tag}: {int(want.valid.sum())}/{q.shape[0]} valid, "
          f"{n_flip} knife-edge flips")
    return max(cerr, nerr, float((got.d2 - want.d2).abs()[fin].max())
               if fin.any() else 0.0)


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
    from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                           MsfLoamConfig)
    from msf_loam_tpu_torch.dataio import preprocess, synthetic
    from msf_loam_tpu_torch.ops import features, odo_corr as oc
    from msf_loam_tpu_torch.ops import pick_rounds as pr
    from msf_loam_tpu_torch.ops import select_fit as sf
    from msf_loam_tpu_torch.slam import mapping, odometry
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline, ate_rmse

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip().splitlines()
    except FileNotFoundError:
        smi = []
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # ---- 1. build
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(kernels.SOURCES)}")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    cfg = MsfLoamConfig(
        features=FeatureConfig(max_points_per_ring=2048, max_less_flat=8192),
        mapping=MappingConfig(map_table_size=1 << 15, map_cell_capacity=32,
                              max_query_points=4096,
                              max_corner_query_points=1024))
    fcfg = cfg.features

    # ---- 2. capture one real frame's kernel calls
    calls = {"pick_rounds": [], "odo_corr": [], "select_fit": []}

    def recorder(name, fn):
        def wrapped(*a, **kw):
            calls[name].append((tuple(t.clone() if torch.is_tensor(t) else t
                                      for t in a), dict(kw)))
            return fn(*a, **kw)
        return wrapped

    bench_world = synthetic.World.corridor(seed=0, size=14.0)
    cap_imgs = images(synthetic, preprocess, fcfg, bench_world,
                      bench_drive(3), 0.004, lambda i: 100 + i, dev)
    pipe = SlamPipeline(cfg, device="cuda")
    for img in cap_imgs[:2]:
        pipe.process_ring_image(img, 0.0)
    patches = [(features, "pick_rounds", pr.pick_rounds),
               (odometry, "odo_corr", oc.odo_corr),
               (odometry, "select_fit", sf.select_fit),
               (mapping, "select_fit", sf.select_fit)]
    for mod, attr, fn in patches:
        setattr(mod, attr, recorder(attr, fn))
    try:
        pipe.process_ring_image(cap_imgs[2], 0.2)
    finally:
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
    torch.cuda.synchronize()
    counts = {k: len(v) for k, v in calls.items()}
    if counts != {"pick_rounds": 1, "odo_corr": 4, "select_fit": 6}:
        fail(f"captured calls per frame {counts}")

    rows = {}
    rng = np.random.default_rng(0)

    # pick_rounds: the frame's planes + seeded ties / sentinels
    (args, kw), = calls["pick_rounds"]
    err = check_pick(torch, pr, args, kw, "frame")
    R, W = args[0].shape
    curv = torch.from_numpy((rng.integers(0, 6, (R, W)) * 0.25)
                            .astype(np.float32)).to(dev)
    sec = torch.from_numpy(np.sort(rng.integers(0, 6, (R, W)), axis=1)
                           .astype(np.int32)).to(dev)
    sec[:, :5] = -1
    ok = torch.from_numpy(rng.uniform(size=(R, W)) > 0.2).to(dev)
    neg = torch.full((), -1e18, device=dev)
    cb0 = torch.from_numpy(np.cumsum(rng.uniform(size=(R, W)) > 0.9, axis=1)
                           .astype(np.int32)).to(dev)
    seeded = (torch.where(ok & (curv > 0.3), curv, neg).contiguous(),
              torch.where(ok & (curv < 0.1), -curv, neg).contiguous(),
              sec.contiguous(), cb0.contiguous())
    check_pick(torch, pr, seeded, kw, "seeded ties")
    ms = cuda_ms(torch, lambda: pr.pick_rounds(*args, **kw))
    pms = cuda_ms(torch, lambda: pr.pick_rounds_plain(*args, **kw), reps=10)
    n_picks = kw["n_sharp"] + -(-kw["n_rest"] // kw["rest_T"]) * kw["rest_T"] \
        + kw["n_flat"]
    nbytes = R * W * 16 + R * W + n_picks * R * kw["S"] * 4
    b, by = bound_ms(nbytes, R * W * n_picks)
    print(f"  pick_rounds ({R}, {W}): kernel {ms:.4f} ms, plain {pms:.3f} ms,"
          f" bound {b:.5f} ms ({by})")
    rows["pick_rounds"] = dict(ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                               max_abs_err=err)

    # odo_corr: the frame's 4 calls (2 rounds x edge, plane) + seeded case
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops=0.0, bytes=0.0)
    err = 0.0
    for i, (a, kw) in enumerate(calls["odo_corr"]):
        q = a[0].float().contiguous()
        planes = oc.ref_planes(a[1], a[2], a[3], kw["K"])
        K, nb = kw["K"], kw["nearby"]
        err = max(err, check_odo(torch, oc, q, planes, K, nb, f"call {i}"))
        N, M = q.shape[0], planes.shape[1]
        t_k = cuda_ms(torch, lambda: oc.odo_corr_planes(q, planes, K, nb))
        t_p = cuda_ms(torch, lambda: oc.odo_corr_plain(q, planes, K, nb),
                      reps=10)
        nbytes = N * 12 + M * 16 + N * (5 + 3 * K) * 4
        nops = N * M * 15
        b, by = bound_ms(nbytes, nops)
        print(f"  odo_corr K={K} N={N} M={M}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.3f} ms, bound {b:.5f} ms ({by})")
        tot["ms"] += t_k
        tot["plain_ms"] += t_p
        tot["bytes"] += nbytes
        tot["ops"] += nops
        if i == 1:       # seeded ties / no-partner sentinels at this shape
            xyz = a[1].clone()
            ring = a[3].clone()
            mask = torch.ones_like(a[2])
            xyz[2000:2200] = xyz[1000:1200]
            ring[2000:2200] = ring[1000:1200]
            ring[3000:3100] = 100
            qs = q.clone()
            qs[:50] = xyz[3001:3051]
            qs[50:100] = xyz[1001:1051]
            p2 = oc.ref_planes(xyz, mask, ring, K)
            check_odo(torch, oc, qs.contiguous(), p2, K, nb, "seeded ties")
            if int((oc.odo_corr_planes(qs.contiguous(), p2, K, nb).c_d2
                    >= 3e38).sum()) < 50:
                fail("odo_corr seeded: the no-partner rows found a partner")
    b, by = bound_ms(tot["bytes"], tot["ops"])
    rows["odo_corr"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"],
                            bound_ms=b, bound_by=by, max_abs_err=err)

    # select_fit: the frame's 6 calls + a seeded rows case with ties
    tot = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0)
    err = 0.0
    for i, (a, kw) in enumerate(calls["select_fit"]):
        cand, q, r2s, r2w = a
        q = q.contiguous()
        tag = f"call {i} {kw.get('mode')} {tuple(cand.shape)}"
        err = max(err, check_select(torch, sf, cand, q, r2s, r2w, kw, tag))
        t_k = cuda_ms(torch, lambda: sf.select_fit(cand, q, r2s, r2w, **kw))
        t_p = cuda_ms(torch, lambda: plain_select(sf, cand, q, r2s, r2w, kw),
                      reps=10)
        N = q.shape[0]
        C = cand.numel() // (3 * N)
        k = kw["k"]
        nbytes = cand.numel() * 4 + N * 12 + N * (k + 7) * 4
        per_cand = {"line": 40, "plane": 50, "plane2": 90}[kw["mode"]] + k
        b, by = bound_ms(nbytes, N * C * per_cand)
        print(f"  select_fit {kw['mode']} N={N} C={C}: kernel {t_k:.4f} ms,"
              f" plain {t_p:.3f} ms, bound {b:.5f} ms ({by})")
        tot["ms"] += t_k
        tot["plain_ms"] += t_p
        tot["bytes"] += nbytes
        tot["ops"] += N * C * per_cand
    N, C = 1024, 256
    qn = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    off = rng.uniform(-1.5, 1.5, (N, C, 3)).astype(np.float32)
    off[:, 128:160] = off[:, 0:32]                      # duplicate distances
    off[:, :, 2] *= 0.02                                # near-planar
    cnd = qn[:, None, :] + off
    cnd[rng.uniform(size=(N, C)) < 0.2] = 1e9           # empty-slab sentinel
    cnd = np.transpose(cnd, (0, 2, 1)).reshape(N, 3 * C)
    for mode in ("line", "plane2"):
        err = max(err, check_select(
            torch, sf, torch.from_numpy(np.ascontiguousarray(cnd)).to(dev),
            torch.from_numpy(qn).to(dev), 1.0, 4.0,
            dict(k=5, mode=mode, min_count=5, min_wide=5), f"seeded {mode}"))
    b, by = bound_ms(tot["bytes"], tot["ops"])
    rows["select_fit"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"],
                              bound_ms=b, bound_by=by, max_abs_err=err)

    # ---- 3. main path
    # accuracy: tests/test_pipeline.py corridor drive
    acc_world = synthetic.World.corridor(seed=0, size=12.0)
    drive = corridor_drive(10)
    acc_imgs = images(synthetic, preprocess, fcfg, acc_world, drive, 0.005,
                      lambda i: 3, dev)
    pipe = SlamPipeline(cfg, device="cuda")
    for i, img in enumerate(acc_imgs):
        pipe.process_ring_image(img, 0.1 * i)
    traj = pipe.trajectory()
    gt = np.asarray([t for t, _ in drive])
    ate = ate_rmse(traj[:, 1:4], gt, align=False)
    print(f"accuracy: ATE {ate:.5f} m over {len(drive)} frames "
          f"(bound 0.05 m)")
    if not np.isfinite(traj).all() or ate >= 0.05:
        fail(f"ATE {ate} m")

    # the plain versions on the CPU, first 3 frames
    cpu = SlamPipeline(cfg, device="cpu")
    worst = 0.0
    for i, img in enumerate(acc_imgs[:3]):
        r = cpu.process_ring_image(img.to("cpu"), 0.1 * i)
        dt = float(np.abs(r.map_pose.t.numpy() - traj[i, 1:4]).max())
        dq = float(np.abs(r.map_pose.q.numpy() - traj[i, 4:8]).max())
        worst = max(worst, dt, dq)
    print(f"cpu plain versions vs card, 3 frames: max |dpose| {worst:.2e} "
          f"(tolerance 1e-3)")
    if worst > 1e-3:
        fail(f"CPU and card mapped poses differ by {worst}")

    # speed: 30 distinct frames of the bench.py drive
    n_frames, warm = 30, 5
    bench_imgs = images(synthetic, preprocess, fcfg, bench_world,
                        bench_drive(n_frames), 0.004, lambda i: 100 + i, dev)
    pipe = SlamPipeline(cfg, device="cuda")
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
            "select_fit": 6 * n_frames}
    print(f"speed: {steady:.2f} scans/s steady state (frames {warm}-"
          f"{n_frames - 1}), first frame {stamps[0] - t_run:.3f} s;"
          f" peak device memory {peak / 2**20:.1f} MiB; launches {launches}")
    if launches != want:
        fail(f"launch counts {launches}, expected {want}")
    pos = pipe.trajectory()[:, 1:4]
    gt = np.asarray([t for t, _ in bench_drive(n_frames)])
    print(f"bench drive: final position error "
          f"{float(np.linalg.norm(pos[-1] - gt[-1])):.4f} m after "
          f"{float(np.linalg.norm(gt[-1] - gt[0])):.2f} m")
    if not np.isfinite(pos).all():
        fail("non-finite poses on the bench drive")

    # ---- 4. where the time goes: host clock per stage (each stage ends
    # in a synchronize, so stages do not overlap) over 5 frames, then a
    # torch.profiler trace of 3 frames
    from msf_loam_tpu_torch.slam import pipeline as pipe_mod
    from msf_loam_tpu_torch.slam import voxel_map as vm
    stage_s = {}

    def staged(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t
            return out
        return wrapped

    stage_patches = [(features, "extract_features"),
                     (odometry, "match_scan2scan"),
                     (pipe_mod, "downsample_features_grouped"),
                     (mapping, "match_scan2map_core"), (vm, "insert")]
    saved = [getattr(m, a) for m, a in stage_patches]
    for (m, a), fn in zip(stage_patches, saved):
        setattr(m, a, staged(a, fn))
    try:
        t0 = time.perf_counter()
        for i, img in enumerate(bench_imgs[5:10]):
            pipe.process_ring_image(img, 4.0 + 0.1 * i)
        frame_s = (time.perf_counter() - t0) / 5
    finally:
        for (m, a), fn in zip(stage_patches, saved):
            setattr(m, a, fn)
    print(f"stages (ms per frame, synchronised, {frame_s * 1e3:.1f} ms "
          f"frame): " + ", ".join(f"{k} {v * 1e3 / 5:.2f}"
                                  for k, v in stage_s.items()))

    # ---- 5. torch.profiler trace of 3 steady frames
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, img in enumerate(bench_imgs[:3]):
            pipe.process_ring_image(img, 3.0 + 0.1 * i)
        wall = time.perf_counter() - t0
    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # device-side events only: each kernel once (the aten op that launched
    # it carries the same device time and is not counted again)
    evs = [e for e in prof.key_averages()
           if str(getattr(e, "device_type", "")).endswith("CUDA")
           and self_dev_us(e) > 0]
    dev_us = sum(self_dev_us(e) for e in evs)
    if dev_us > 0:
        print(f"profile: 3 frames {wall * 1e3:.1f} ms wall (traced), device "
              f"busy {dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%),"
              f" {sum(e.count for e in evs)} kernel launches")
        for e in sorted(evs, key=lambda e: -self_dev_us(e))[:15]:
            print(f"  {self_dev_us(e) / 1e3:8.3f} ms {e.count:5d}x "
                  f"{e.key[:90]}")
    else:
        print("profile: no device time in the trace (not measured)")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"msf_loam_tpu_torch/csrc/{name}.cu",
             replaces=REPLACES[name], launches=launches[name],
             max_abs_err=rows[name]["max_abs_err"], ms=rows[name]["ms"],
             plain_ms=rows[name]["plain_ms"], bound_ms=rows[name]["bound_ms"],
             bound_by=rows[name]["bound_by"], library_ms=None)
        for name in kernels.SOURCES]}))
    print(card)
    print(f"total {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
