"""The comparison that decides ``correct``: the program's frames against
the plain reference (``portbench/ref/``), one frame at a time.

For each session the run checks (the stream's, or the fleet lanes drawn
from the seed), the reference replays every frame in float32, the
configuration's precision, on the same noisy ring images the program was
given. Before each compared frame its state is the program's: maps that
it built itself from the scans, inserting at the program's mapped poses,
and the program's pose state after the frame before. From there it works out the frame's odometry step
and mapped pose, and the gap to the program's is read; then it moves on
with the program's poses (as a served model's tokens are scored under
teacher forcing). Once the session ends, each map's count of points is
compared with the program's. The numbers (a cell's traffic file holds
the limits of those it compares):

* ``step_gap_m``: the largest translation gap of an odometry step (m);
* ``pose_gap_m``: the largest translation gap of a mapped pose (m);
* ``pose_gap_median_m``: the largest, over the sessions, of the median
  mapped-pose gap of a session's compared frames (m): steady where one
  frame's discrete choice flips, and moved by a session whose answers are
  wrong throughout;
* ``rot_gap_deg``: the largest rotation gap of either (degrees);
* ``map_count_gap``: the largest relative gap of a session's map point
  counts: the corner and the surface map's gaps over their sum;
* ``not_finite``: poses of the run that are not finite.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from portbench.ref import frame as ref

NUMBERS = ("step_gap_m", "pose_gap_m", "pose_gap_median_m", "rot_gap_deg",
           "map_count_gap", "not_finite")


class Session(NamedTuple):
    """One checked session: per frame the ring image the program was
    given (``RingImage``-like, any device), its time, and the program's
    pose state after it (``ref.State`` of float tensors); and the
    program's final (corner, surface) map counts, or None where the
    session's maps are gone (a session that ended before the run did)."""
    images: Sequence
    times: Sequence[float]
    states: Sequence[ref.State]
    counts: Optional[tuple]
    label: str


def _pose(p, device) -> "ref.Pose":
    dt = torch.get_default_dtype()
    return ref.Pose(p.t.to(device, dt), p.q.to(device, dt))


def _rot_deg(q1: torch.Tensor, q2: torch.Tensor) -> float:
    """The angle of the rotation between two wxyz quaternions, in float64
    (an arccos of their dot product rounds small angles to 0)."""
    a = q1.double().cpu() / q1.double().norm().cpu()
    b = q2.double().cpu() / q2.double().norm().cpu()
    w = float((a * b).sum())
    v = a[0] * b[1:] - b[0] * a[1:] - torch.linalg.cross(a[1:], b[1:])
    return math.degrees(2.0 * math.atan2(float(v.norm()), abs(w)))


def _finite(st: ref.State) -> bool:
    return all(bool(torch.isfinite(x).all())
               for p in st for x in (p.t, p.q))


def compare(sessions: List[Session], slam: dict, device, batched: bool,
            compare_frames: Optional[set] = None,
            dtype: torch.dtype = torch.float32) -> Dict:
    """The numbers over ``sessions``. ``compare_frames``: the frame indices
    (within a session) whose estimate is compared; None compares all.
    Returns the numbers and notes."""
    cfg = ref.FrameConfig.from_dict(slam)
    worst = dict(step_gap_m=0.0, pose_gap_m=0.0, pose_gap_median_m=0.0,
                 rot_gap_deg=0.0, map_count_gap=0.0, not_finite=0)
    where = {}
    n_cmp = 0
    with ref.precision(dtype), torch.no_grad():
        for s in sessions:
            rp = ref.Replay(cfg, device, batched)
            pose_gaps = []
            for j, (img, t, st) in enumerate(zip(s.images, s.times,
                                                 s.states)):
                if not _finite(st):
                    where["not_finite"] = f"{s.label} frame {j}"
                    break
                st = ref.State(*(_pose(p, device) for p in st))
                scan = rp.scan(img, t)
                if compare_frames is None or j in compare_frames:
                    est = rp.frame(scan)
                    step = st.c2l if rp.prev is not None else \
                        ref.Pose.identity(device)
                    gaps = dict(
                        step_gap_m=float((est.step.t - step.t).norm()),
                        pose_gap_m=float((est.map.t - st.map.t).norm()),
                        rot_gap_deg=max(_rot_deg(est.step.q, step.q),
                                        _rot_deg(est.map.q, st.map.q)))
                    for k, v in gaps.items():
                        if not v <= worst[k]:
                            worst[k] = v if math.isfinite(v) else math.inf
                            where[k] = f"{s.label} frame {j}"
                    pose_gaps.append(gaps["pose_gap_m"])
                    n_cmp += 1
                rp.advance(scan, st)
            if pose_gaps:
                med = float(np.median(pose_gaps))
                if not med <= worst["pose_gap_median_m"]:
                    worst["pose_gap_median_m"] = \
                        med if math.isfinite(med) else math.inf
                    where["pose_gap_median_m"] = s.label
            if s.counts is not None and rp.frames == len(s.states):
                want = rp.counts()
                gap = sum(abs(a - b) for a, b in zip(s.counts, want)) / \
                    max(sum(want), 1)
                if gap > worst["map_count_gap"]:
                    worst["map_count_gap"] = gap
                    where["map_count_gap"] = (
                        f"{s.label}: (corner, surface) points {s.counts} "
                        f"against {want}")
    return {"numbers": worst, "where": where, "frames_compared": n_cmp,
            "sessions": len(sessions)}


def own_states(sessions: List[Session], slam: dict, device, batched: bool,
               dtype: torch.dtype, tf32: bool) -> List[Session]:
    """The reference run in the program's place: each session's states
    and final counts as the reference gives them running on its own
    estimates, in ``dtype`` (with TF32 products where ``tf32``)."""
    cfg = ref.FrameConfig.from_dict(slam)
    out = []
    with ref.precision(dtype, tf32), torch.no_grad():
        for s in sessions:
            rp = ref.Replay(cfg, device, batched)
            states = []
            for img, t in zip(s.images, s.times):
                scan = rp.scan(img, t)
                st = rp.own_state(rp.frame(scan))
                rp.advance(scan, st)
                states.append(ref.State(*(ref.Pose(p.t.float(), p.q.float())
                                          for p in st)))
            out.append(s._replace(states=states, counts=rp.counts()))
    return out


def sample_lanes(seed: int, lanes: int, n: int) -> List[int]:
    """``n`` lanes drawn from the seed, one from each of ``n`` equal
    stretches of the batch (so every half of it is checked)."""
    rng = np.random.default_rng([seed, 1])
    edges = np.linspace(0, lanes, n + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]
