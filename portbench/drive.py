"""The general feed of every cell: one session of the program fed scan
by scan (``mode: stream``) or B lanes through the batched pipeline
(``mode: fleet``), warmed up, timed over a window, traced over a short
stretch after it, and checked against the plain reference.

Everything that belongs to one configuration or one traffic mix comes
from its JSON file; this module holds only what every cell shares.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional

import numpy as np
import torch

from portbench import check, devtrace, pool, roofline
from portbench.ref.frame import State


class Inputs:
    """The configuration's ring-image pool on the device. Each frame's
    ring images, with point noise drawn from the run's seed by a generator
    on the card, are made on a CUDA stream of the harness's own, which the
    program's stream then waits for: the device-time metrics leave that
    stream out."""

    def __init__(self, cfg: dict, arrays: dict, seed: int, device):
        self.F = cfg["frames"]
        self.dt = cfg["sensor"]["scan_period"]
        self.sigma = cfg["sensor"]["point_noise_m"]
        self.device = device
        self.xyz = torch.from_numpy(arrays["xyz"]).to(device)
        self.rel = torch.from_numpy(arrays["rel_time"]).to(device)
        self.mask = torch.from_numpy(arrays["mask"]).to(device)
        self.maskf = self.mask.to(torch.float32)[..., None]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def mark(self) -> None:
        """The marker kernel on the harness's stream, which names that
        stream in a device trace (``devtrace.Trace``)."""
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(1000)

    def make(self, ks, keep: Optional[torch.Tensor] = None):
        """Pool frame ``ks`` (an int) as (R, W, ...) leaves, or frames
        ``ks`` (a (B,) long tensor, one a lane) as (B, R, W, ...), with
        fresh noise; and the noisy points of the lanes ``keep`` (for the
        check)."""
        from msf_loam_tpu_torch.core.pointcloud import RingImage
        main = torch.cuda.current_stream(self.device) \
            if self.stream is not None else None
        if main is not None:
            # the frame indices may come from the program's stream
            self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream) if self.stream is not None \
                else _nothing():
            xyz, rel, mask = self.xyz[ks], self.rel[ks], self.mask[ks]
            noise = torch.randn(xyz.shape, generator=self.gen,
                                device=self.device)
            xyz = torch.addcmul(xyz, noise, self.maskf[ks], value=self.sigma)
            kept = xyz.index_select(0, keep) if keep is not None else None
        if main is not None:
            main.wait_stream(self.stream)
            for t in (xyz, rel, mask):
                t.record_stream(main)
        return RingImage(xyz, rel, mask), kept


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


class Stream:
    """One ``SlamPipeline`` session over the pool from frame 0; at the
    pool's end a new session starts at frame 0 (a car's next drive)."""

    lanes = 1

    def __init__(self, traffic: dict, slam_cfg, inputs: Inputs, seed: int,
                 device):
        self.slam_cfg, self.inputs, self.device = slam_cfg, inputs, device
        self.sessions: List[dict] = []
        self.produced = 0
        self._new_session()

    def _new_session(self):
        from msf_loam_tpu_torch.slam.pipeline import SlamPipeline
        self.k = 0
        self.pipe = SlamPipeline(self.slam_cfg, device=self.device)
        self.sessions.append(dict(images=[], times=[], states=[]))

    def step(self) -> int:
        if self.k >= self.inputs.F:
            self._new_session()
        ts = self.k * self.inputs.dt
        img, _ = self.inputs.make(self.k)
        p = self.pipe
        p.process_ring_image(img, ts)
        s = self.sessions[-1]
        s["images"].append(img)
        s["times"].append(ts)
        s["states"].append(State(p.pose_curr2last, p.pose_odom,
                                 p.pose_odom2map, p.pose_map))
        self.k += 1
        self.produced += 1
        return 1

    def finish(self, seed: int, check_cfg: dict) -> List[check.Session]:
        """The sessions to check, the last with the program's map counts;
        frees the program's state."""
        counts = (int(self.pipe.corner_map.total_points()),
                  int(self.pipe.surf_map.total_points()))
        self.pipe = None
        self.not_finite = sum(_not_finite(st) for s in self.sessions
                              for st in s["states"])
        out = []
        for i, s in enumerate(self.sessions):
            out.append(check.Session(
                s["images"], s["times"], s["states"],
                counts if i == len(self.sessions) - 1 else None,
                f"session {i}"))
        return out


class Fleet:
    """B lanes through ``batch_pipeline.run_batch``, one frame a call. Each
    lane starts at a frame offset drawn from the seed (``start_offsets``:
    below that many frames, inside the standstill ramp) with its own noise
    and maps, so the lanes do different work; when the first lane reaches
    the pool's end every lane starts a new session together."""

    def __init__(self, cfg: dict, traffic: dict, slam_cfg, inputs: Inputs,
                 seed: int, device):
        self.slam_cfg, self.inputs, self.device = slam_cfg, inputs, device
        self.lanes = traffic["lanes"]
        self.rings = cfg["sensor"]["rings"]
        rng = np.random.default_rng([seed, 0])
        self.offsets = torch.as_tensor(
            rng.integers(0, traffic["start_offsets"], self.lanes),
            dtype=torch.long, device=device)
        self.keep = check.sample_lanes(seed, self.lanes,
                                       traffic["check"]["lanes"])
        self.keep_t = torch.as_tensor(self.keep, device=device)
        self.span = int(self.offsets.max())
        self.sessions: List[dict] = []
        self.produced = 0
        self._new_session()

    def _new_session(self):
        from msf_loam_tpu_torch.slam import batch_pipeline
        self.j = 0
        self.state = batch_pipeline.init_batch_state(
            self.slam_cfg, self.lanes, n_rings=self.rings,
            device=self.device)
        self.sessions.append(dict(xyz=[], states=[]))

    def step(self) -> int:
        from msf_loam_tpu_torch.core.pointcloud import RingImage
        from msf_loam_tpu_torch.slam import batch_pipeline
        if self.j + self.span >= self.inputs.F:
            self._new_session()
        img, kept = self.inputs.make(self.offsets + self.j, self.keep_t)
        self.state, poses = batch_pipeline.run_batch(
            self.slam_cfg, self.state, RingImage(*(a[None] for a in img)))
        st = self.state
        s = self.sessions[-1]
        s["xyz"].append(kept)
        s["states"].append(State(st.pose_c2l, st.pose_odom, st.pose_o2m,
                                 type(st.pose_odom)(poses.t[0], poses.q[0])))
        self.j += 1
        self.produced += 1
        return self.lanes

    def finish(self, seed: int, check_cfg: dict) -> List[check.Session]:
        from msf_loam_tpu_torch.core.pointcloud import RingImage
        H = self.slam_cfg.mapping.map_table_size
        counts = [m.count.view(self.lanes, H).sum(dim=1).cpu()
                  for m in (self.state.corner_map, self.state.surf_map)]
        self.state = None
        self.not_finite = sum(_not_finite(st) for s in self.sessions
                              for st in s["states"])
        inp = self.inputs
        out = []
        for i, s in enumerate(self.sessions):
            last = i == len(self.sessions) - 1
            for n, b in enumerate(self.keep):
                ks = [int(self.offsets[b]) + j for j in range(len(s["xyz"]))]
                images = [RingImage(x[n], inp.rel[k], inp.mask[k])
                          for x, k in zip(s["xyz"], ks)]
                states = [State(*(type(p)(p.t[b], p.q[b]) for p in st))
                          for st in s["states"]]
                out.append(check.Session(
                    images, [0.0] * len(ks), states,
                    (int(counts[0][b]), int(counts[1][b])) if last else None,
                    f"session {i} lane {b}"))
        return out


def _not_finite(st: State) -> int:
    """Lanes whose mapped pose is not finite (0 or 1 for a stream)."""
    p = st.map
    ok = torch.isfinite(p.t).all(dim=-1) & torch.isfinite(p.q).all(dim=-1)
    return int((~ok).sum())


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self):
        self.setup_s = 0.0
        self.wall_s = 0.0
        self.scans = 0
        self.lanes = 1
        self.step_s: List[float] = []
        self.window_trace: Optional[devtrace.Trace] = None
        self.stretch: Optional[devtrace.Trace] = None
        self.stretch_scans = 0
        self.recorder: Optional[roofline.Recorder] = None
        self.setup_phases = {}       # seconds since the start, by phase
        self.memory_peak_bytes = 0


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(feed, seconds: float, device, run: Run) -> None:
    """Steps until ``seconds`` have passed; each step ends in a
    synchronise, so the last one's end closes the window."""
    sync(device)
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        run.scans += feed.step()
        sync(device)
        b = time.perf_counter()
        run.step_s.append(b - a)
        if b - t0 >= seconds:
            break
    run.wall_s = b - t0


def make_feed(cfg: dict, traffic: dict, seed: int, device, workers: int):
    from msf_loam_tpu_torch.config import MsfLoamConfig
    slam_cfg = MsfLoamConfig.from_dict(cfg["slam"])
    t0 = time.perf_counter()
    arrays = pool.load(cfg, workers)
    t1 = time.perf_counter()
    inputs = Inputs(cfg, arrays, seed, device)
    sync(device)
    print(f"pool: {t1 - t0:.2f} s to load, {time.perf_counter() - t1:.2f} s "
          f"to the device", file=sys.stderr)
    if traffic["mode"] == "stream":
        return Stream(traffic, slam_cfg, inputs, seed, device)
    if traffic["mode"] == "fleet":
        return Fleet(cfg, traffic, slam_cfg, inputs, seed, device)
    raise ValueError(f"unknown traffic mode {traffic['mode']!r}")


def drive(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
          device_trace_window: bool, device, t_start: float,
          workers: int = 8):
    """Set up, warm up, time the window (recording the card's operations
    over it where ``device_trace_window``), trace a stretch after it where
    ``trace``. Returns (run, feed); the feed still holds the program's
    state."""
    run = Run()
    feed = make_feed(cfg, traffic, seed, device, workers)
    run.lanes = feed.lanes
    sync(device)
    run.setup_phases["feed"] = time.perf_counter() - t_start
    for _ in range(traffic["warmup_frames"]):
        feed.step()
    sync(device)
    # the profiler's own start (CUPTI's first takes 10-17 s) comes after:
    # it is the benchmark's cost, not the program's, and precedes the window
    run.setup_s = time.perf_counter() - t_start
    if device_trace_window and not trace and device.type == "cuda":
        with devtrace.record(False, device, feed.inputs.mark) as got:
            window(feed, seconds, device, run)
        run.window_trace = got[0]
    else:
        window(feed, seconds, device, run)
    if trace:
        run.recorder = roofline.Recorder()
        with run.recorder.active(), \
                devtrace.record(True, device, feed.inputs.mark) as got:
            for _ in range(traffic["trace_frames"]):
                run.stretch_scans += feed.step()
        run.stretch = got[0]
    if device.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    return run, feed


def judge(feed, seed: int, cfg: dict, traffic: dict, device,
          sessions=None) -> dict:
    """The check, after the program's state is freed (``sessions``: the
    sessions to judge in place of the program's, for a control)."""
    chk = traffic["check"]
    got = feed.finish(seed, chk)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if sessions is not None:
        got = sessions(got)
    frames = sum(len(s.states) for s in got)
    n = chk.get("compare_frames")
    pick = None
    if n is not None and n < frames:
        length = max(len(s.states) for s in got)
        rng = np.random.default_rng([seed, 2])
        pick = set(int(x) for x in rng.choice(length, min(n, length),
                                              replace=False))
    t0 = time.perf_counter()
    out = check.compare(got, cfg["slam"], device,
                        batched=traffic["mode"] == "fleet",
                        compare_frames=pick)
    out["seconds"] = time.perf_counter() - t0
    out["numbers"]["not_finite"] += feed.not_finite
    return out
