"""Frozen copy of the port's synthetic LiDAR world and drive (numpy).

The benchmark's own generator: the street-grid world of the KITTI-style
cells (ground plane, depth-jittered building facades, lamp poles), the
spinning multi-ring ray caster with motion distortion, the filleted
vehicle paths with their exact kinematic state and the street routes. It
is copied from ``msf_loam_tpu_torch/dataio/synthetic.py`` with its numpy
arithmetic unchanged (``portbench/tests`` holds it bit-equal to the port
at a small size), and kept here so that no change to the program can
change the benchmark's inputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Plane:
    point: np.ndarray   # (3,)
    normal: np.ndarray  # (3,) unit
    half_extent: float = 30.0  # ray hits accepted within this distance of `point`


@dataclasses.dataclass
class Pole:
    base: np.ndarray  # (3,) base position
    radius: float = 0.15
    height: float = 6.0


@dataclasses.dataclass
class RectPlane:
    """Finite rectangular facade: center, unit normal, in-plane unit axis u
    (v = n x u), half extents along u/v."""

    center: np.ndarray
    normal: np.ndarray
    u: np.ndarray
    half_u: float
    half_v: float


@dataclasses.dataclass
class World:
    planes: List[Plane]
    poles: List[Pole]
    rects: List[RectPlane] = dataclasses.field(default_factory=list)

    @staticmethod
    def street_grid(seed: int = 0, n_blocks: int = 5, block: float = 48.0,
                    street: float = 16.0, sensor_height: float = 1.8,
                    pole_spacing: float = 12.0) -> "World":
        """Manhattan street grid for KITTI-style urban drives.

        ``n_blocks`` x ``n_blocks`` city blocks on a ``block + street`` pitch
        with street centerlines at x,y = i*pitch. Each block carries one
        building whose facades are split into depth-jittered segments
        (the depth discontinuities are vertical edges — LOAM corner
        features), plus lamp poles along the street edges. Ground plane at
        ``-sensor_height`` (vehicle-mounted sensor). The reference validates
        on KITTI odometry (README.md:44-47, kitti_helper.cc); this is the
        zero-egress stand-in with exact ground truth.
        """
        rng = np.random.default_rng(seed)
        pitch = block + street
        ext = n_blocks * pitch
        planes = [Plane(np.array([ext / 2, ext / 2, -sensor_height]),
                        np.array([0.0, 0.0, 1.0]), ext * 1.5)]
        rects: List[RectPlane] = []
        Z = np.array([0.0, 0.0, 1.0])
        for bi in range(n_blocks):
            for bj in range(n_blocks):
                # block interior spans [lo, hi] on each axis
                lo = np.array([bi * pitch + street / 2, bj * pitch + street / 2])
                hi = lo + block
                setback = rng.uniform(2.0, 6.0)
                h = rng.uniform(6.0, 24.0)
                b_lo, b_hi = lo + setback, hi - setback
                zc = h / 2 - sensor_height
                # 4 facades: (axis, sign) -> outward normal along axis*sign
                for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1)):
                    other = 1 - axis
                    face = b_lo[axis] if sign < 0 else b_hi[axis]
                    span0, span1 = b_lo[other], b_hi[other]
                    n_seg = rng.integers(2, 4)
                    cuts = np.linspace(span0, span1, n_seg + 1)
                    for k in range(n_seg):
                        depth = rng.uniform(-1.5, 1.5)
                        c = np.zeros(3)
                        c[axis] = face + sign * depth
                        c[other] = 0.5 * (cuts[k] + cuts[k + 1])
                        c[2] = zc
                        normal = np.zeros(3)
                        normal[axis] = float(sign)
                        u = np.zeros(3)
                        u[other] = 1.0
                        rects.append(RectPlane(
                            center=c, normal=normal, u=u,
                            half_u=0.5 * (cuts[k + 1] - cuts[k]),
                            half_v=h / 2))
        poles: List[Pole] = []
        n_lines = n_blocks + 1
        for i in range(n_lines):
            cl = i * pitch  # street centerline
            for side in (-1.0, 1.0):
                off = side * (street / 2 - 1.0)
                for s_ in np.arange(pole_spacing / 2, ext, pole_spacing):
                    if rng.uniform() < 0.35:
                        continue  # thin them out irregularly
                    jit = rng.uniform(-1.0, 1.0)
                    # poles along both x-parallel and y-parallel streets
                    poles.append(Pole(np.array([s_ + jit, cl + off,
                                                -sensor_height]),
                                      radius=0.12, height=5.0))
                    poles.append(Pole(np.array([cl + off, s_ + jit,
                                                -sensor_height]),
                                      radius=0.12, height=5.0))
        return World(planes, poles, rects)

    def cull(self, origin: np.ndarray, max_range: float) -> "World":
        """Sub-world of primitives reachable from ``origin``."""
        o = np.asarray(origin, dtype=np.float64)
        rects = [r for r in self.rects
                 if np.linalg.norm(r.center - o)
                 <= max_range + float(np.hypot(r.half_u, r.half_v))]
        poles = [p for p in self.poles
                 if np.linalg.norm(p.base[:2] - o[:2])
                 <= max_range + p.radius]
        return World(self.planes, poles, rects)


def _raycast_rects(rects: List[RectPlane], origins: np.ndarray,
                   d_world: np.ndarray, t_hit: np.ndarray,
                   chunk: int = 32768) -> np.ndarray:
    """Nearest-hit distances against finite rectangles, vectorized over
    (ray-chunk x all-rects)."""
    if not rects:
        return t_hit
    C = np.stack([r.center for r in rects]).astype(np.float32)
    Nn = np.stack([r.normal for r in rects]).astype(np.float32)
    U = np.stack([r.u for r in rects]).astype(np.float32)
    V = np.cross(Nn, U)
    hu = np.array([r.half_u for r in rects], dtype=np.float32)
    hv = np.array([r.half_v for r in rects], dtype=np.float32)
    o32 = origins.astype(np.float32)
    d32 = d_world.astype(np.float32)
    for s in range(0, len(d32), chunk):
        o = o32[s:s + chunk]
        d = d32[s:s + chunk]
        denom = d @ Nn.T
        num = np.einsum("nmk,mk->nm", C[None] - o[:, None, :], Nn)
        ok = np.abs(denom) > 1e-6
        t = np.where(ok, num / np.where(ok, denom, 1.0), np.inf)
        t_fin = np.where(np.isfinite(t), t, 0.0)
        hit = o[:, None, :] + d[:, None, :] * t_fin[..., None] - C[None]
        a = np.einsum("nmk,mk->nm", hit, U)
        b = np.einsum("nmk,mk->nm", hit, V)
        ok &= ((t > 0.1) & (np.abs(a) <= hu[None])
               & (np.abs(b) <= hv[None]))
        t = np.where(ok, t, np.inf).min(axis=1)
        t_hit[s:s + chunk] = np.minimum(t_hit[s:s + chunk], t)
    return t_hit


def _raycast(world: World, origins: np.ndarray, d_world: np.ndarray,
             max_range: float) -> np.ndarray:
    """Per-ray hit distance for rays (origins (N,3), directions (N,3))."""
    t_hit = np.full(len(d_world), np.inf)
    for pl in world.planes:
        denom = d_world @ pl.normal
        safe = np.where(np.abs(denom) > 1e-6, denom, 1.0)
        t = np.where(np.abs(denom) > 1e-6,
                     ((pl.point[None] - origins) @ pl.normal) / safe, np.inf)
        t = np.minimum(t, 1e6)
        hit_pt = origins + d_world * t[:, None]
        ok = (t > 0.1) & (np.linalg.norm(hit_pt - pl.point, axis=1) < pl.half_extent)
        t_hit = np.where(ok & (t < t_hit), t, t_hit)
    if world.poles:
        # infinite-cylinder intersection in xy, then z-extent check
        B = np.stack([p.base for p in world.poles]).astype(np.float32)
        rad = np.array([p.radius for p in world.poles], dtype=np.float32)
        hgt = np.array([p.height for p in world.poles], dtype=np.float32)
        chunk = 32768
        for s0 in range(0, len(d_world), chunk):
            o = origins[s0:s0 + chunk].astype(np.float32)
            d = d_world[s0:s0 + chunk].astype(np.float32)
            oc = o[:, None, :2] - B[None, :, :2]
            dxy = d[:, :2]
            a = np.sum(dxy * dxy, axis=1)[:, None]
            b = 2 * np.einsum("nk,nmk->nm", dxy, oc)
            c = np.sum(oc * oc, axis=2) - rad[None] ** 2
            disc = b * b - 4 * a * c
            ok = (disc > 0) & (a > 1e-9)
            sq = np.sqrt(np.maximum(disc, 0.0))
            t = np.where(ok, (-b - sq) / np.maximum(2 * a, 1e-9), np.inf)
            z = o[:, 2:3] + d[:, 2:3] * t
            ok &= (t > 0.1) & (z >= B[None, :, 2]) & (z <= B[None, :, 2] + hgt[None])
            t = np.where(ok, t, np.inf).min(axis=1)
            t_hit[s0:s0 + chunk] = np.minimum(t_hit[s0:s0 + chunk], t)
    t_hit = _raycast_rects(world.rects, origins, d_world, t_hit)
    t_hit = np.where(t_hit < max_range, t_hit, np.inf)
    return t_hit


def simulate_scan(world: World, t_world: np.ndarray, R_world: np.ndarray,
                  n_rings: int = 16, pts_per_ring: int = 900,
                  fov_up: float = 15.0, fov_down: float = -15.0,
                  max_range: float = 80.0, noise: float = 0.0,
                  seed: int = 0,
                  linear_vel: np.ndarray = None,
                  yaw_rate: float = 0.0,
                  scan_period: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast a spinning-LiDAR scan from pose (R_world, t_world).

    Returns (xyz (N,3) in the scan-start sensor frame, ring (N,)), emitted
    azimuth-major like a real packet stream. With ``linear_vel``/
    ``yaw_rate`` the sensor moves during the scan and each column is
    reported in its instantaneous sensor frame (motion distortion).
    """
    rng = np.random.default_rng(seed)
    if world.rects or len(world.poles) > 64:
        world = world.cull(t_world, max_range + 5.0)
    elev = np.radians(np.linspace(fov_down, fov_up, n_rings))
    azim = -np.linspace(0, 2 * np.pi, pts_per_ring, endpoint=False)  # CW

    az, el = np.meshgrid(azim, elev, indexing="ij")  # (A, R)
    dirs = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    ).reshape(-1, 3)
    ring = np.tile(np.arange(n_rings, dtype=np.int32), pts_per_ring)

    s = np.repeat(np.arange(pts_per_ring) / pts_per_ring, n_rings)
    if linear_vel is None and yaw_rate == 0.0:
        origins = np.broadcast_to(t_world, dirs.shape).copy()
        d_world = dirs @ R_world.T
    else:
        lv = np.zeros(3) if linear_vel is None else np.asarray(linear_vel)
        dt = s * scan_period
        origins = t_world[None] + lv[None] * dt[:, None]
        yaw = yaw_rate * dt
        cy, sy = np.cos(yaw), np.sin(yaw)
        dx = cy * dirs[:, 0] - sy * dirs[:, 1]
        dy = sy * dirs[:, 0] + cy * dirs[:, 1]
        d_local = np.stack([dx, dy, dirs[:, 2]], axis=1)
        d_world = d_local @ R_world.T

    t_hit = _raycast(world, origins, d_world, max_range)
    hit = np.isfinite(t_hit)
    pts_world = origins + d_world * np.where(hit, t_hit, 0.0)[:, None]
    if noise > 0:
        pts_world = pts_world + rng.normal(scale=noise, size=pts_world.shape)
    if linear_vel is None and yaw_rate == 0.0:
        pts_sensor = (pts_world[hit] - t_world) @ R_world
    else:
        rel_w = pts_world - origins
        rel_l = rel_w @ R_world
        px = cy * rel_l[:, 0] + sy * rel_l[:, 1]
        py = -sy * rel_l[:, 0] + cy * rel_l[:, 1]
        pts_sensor = np.stack([px, py, rel_l[:, 2]], axis=1)[hit]
    return pts_sensor.astype(np.float32), ring[hit]


# ---------------------------------------------------------------------------
# Ground-vehicle trajectories: piecewise line/arc paths with closed-form
# kinematic state (position, yaw, velocity, yaw rate) — drives the KITTI-
# style street-grid evaluation and synthesizes exact IMU streams.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Segment:
    length: float
    # line: p0 + s*dir ; arc: center + r*[cos, sin](ang0 + sgn*s/r)
    kind: str              # "line" | "arc"
    p0: np.ndarray         # line start / arc center (2,)
    d0: np.ndarray         # line dir (2,) / [ang0, signed curvature 1/r]


class VehiclePath:
    """Arclength-parameterized planar path: straight legs joined by
    circular fillet arcs at every interior waypoint."""

    def __init__(self, segments: List[_Segment]):
        self.segments = segments
        self.cum = np.concatenate(
            [[0.0], np.cumsum([s.length for s in segments])])
        self.total_length = float(self.cum[-1])

    @staticmethod
    def from_waypoints(wps: np.ndarray, turn_radius: float = 8.0
                       ) -> "VehiclePath":
        """Fillet a 2D waypoint polyline with arcs of ``turn_radius``."""
        wps = np.asarray(wps, dtype=np.float64)[:, :2]
        segs: List[_Segment] = []
        cur = wps[0]
        for i in range(1, len(wps) - 1):
            A, B, C = cur, wps[i], wps[i + 1]
            d1 = B - A
            d2 = C - B
            l1, l2 = np.linalg.norm(d1), np.linalg.norm(d2)
            d1, d2 = d1 / l1, d2 / l2
            cross = d1[0] * d2[1] - d1[1] * d2[0]
            dot = float(np.clip(d1 @ d2, -1.0, 1.0))
            ang = np.arctan2(abs(cross), dot)
            if ang < 1e-6:         # collinear — extend the straight leg
                continue
            tdist = turn_radius * np.tan(ang / 2)
            if tdist > l1 - 1e-6 or tdist > l2 - 1e-6:
                raise ValueError("turn radius too large for waypoint legs")
            pin = B - d1 * tdist    # arc entry
            straight = float(np.linalg.norm(pin - cur))
            if straight > 1e-9:
                segs.append(_Segment(straight, "line", cur.copy(), d1.copy()))
            sgn = 1.0 if cross > 0 else -1.0
            n1 = sgn * np.array([-d1[1], d1[0]])   # toward arc center
            center = pin + n1 * turn_radius
            ang0 = np.arctan2(pin[1] - center[1], pin[0] - center[0])
            segs.append(_Segment(turn_radius * ang, "arc", center,
                                 np.array([ang0, sgn / turn_radius])))
            cur = B + d2 * tdist    # arc exit
        tail = float(np.linalg.norm(wps[-1] - cur))
        if tail > 1e-9:
            d = (wps[-1] - cur) / tail
            segs.append(_Segment(tail, "line", cur.copy(), d))
        return VehiclePath(segs)

    def state(self, s: np.ndarray):
        """Vectorized state at arclengths ``s``: (pos (N,2), yaw (N,),
        curvature kappa (N,)); yaw = tangent heading, yaw_rate = v*kappa."""
        s = np.clip(np.asarray(s, dtype=np.float64), 0.0,
                    self.total_length - 1e-9)
        idx = np.clip(np.searchsorted(self.cum, s, side="right") - 1,
                      0, len(self.segments) - 1)
        ds = s - self.cum[idx]
        pos = np.zeros((len(s), 2))
        yaw = np.zeros(len(s))
        kap = np.zeros(len(s))
        for k, seg in enumerate(self.segments):
            m = idx == k
            if not m.any():
                continue
            if seg.kind == "line":
                pos[m] = seg.p0[None] + ds[m, None] * seg.d0[None]
                yaw[m] = np.arctan2(seg.d0[1], seg.d0[0])
            else:
                ang0, kappa = seg.d0
                r = 1.0 / abs(kappa)
                sgn = np.sign(kappa)
                a = ang0 + sgn * ds[m] / r
                pos[m] = seg.p0[None] + r * np.stack(
                    [np.cos(a), np.sin(a)], axis=1)
                yaw[m] = a + sgn * np.pi / 2
                kap[m] = kappa
        return pos, yaw, kap


def speed_profile(times: np.ndarray, speed: float, accel: float = None):
    """Arclength / speed / tangential-accel at ``times`` for a drive that
    ramps 0 -> ``speed`` at ``accel`` then cruises (None = always cruising).
    Vehicles start from standstill — without the ramp the first scan pair
    jumps a full meter from an identity initial guess."""
    times = np.asarray(times, dtype=np.float64)
    if accel is None:
        return (speed * times, np.full(len(times), speed),
                np.zeros(len(times)))
    t_ramp = speed / accel
    ramp = times < t_ramp
    tc = np.clip(times, 0.0, t_ramp)
    s = 0.5 * accel * tc ** 2 + speed * np.maximum(times - t_ramp, 0.0)
    v = np.where(ramp, accel * np.maximum(times, 0.0), speed)
    at = np.where(ramp, accel, 0.0)
    return s, v, at


def drive_states(path: VehiclePath, speed: float, times: np.ndarray,
                 accel: float = None):
    """Vehicle kinematic state at ``times``.

    Returns dict of p (N,3), R (N,3,3), v_world (N,3), yaw_rate (N,),
    accel_world (N,3). ``accel`` enables a standstill-to-cruise ramp.
    """
    times = np.asarray(times, dtype=np.float64)
    s, v, at = speed_profile(times, speed, accel)
    pos2, yaw, kap = path.state(s)
    n = len(times)
    p = np.concatenate([pos2, np.zeros((n, 1))], axis=1)
    c, sn = np.cos(yaw), np.sin(yaw)
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 1] = c, -sn
    R[:, 1, 0], R[:, 1, 1] = sn, c
    R[:, 2, 2] = 1.0
    tangent = np.stack([c, sn, np.zeros(n)], axis=1)
    normal = np.stack([-sn, c, np.zeros(n)], axis=1)
    yaw_rate = v * kap
    a_world = at[:, None] * tangent + (v * yaw_rate)[:, None] * normal
    return {"p": p, "R": R, "v_world": v[:, None] * tangent,
            "yaw_rate": yaw_rate, "accel_world": a_world}


def street_route(n_blocks: int = 5, block: float = 48.0, street: float = 16.0,
                 route: str = "tour", margin_blocks: int = 0) -> np.ndarray:
    """Waypoints (on street centerlines) for a drive through
    ``World.street_grid`` with the same grid parameters.

    Routes: "tour" — an S-shaped sweep with many 90-degree turns (KITTI-
    style exploration, ~n_blocks^2 * pitch meters); "lap" — one closed
    rectangle around the central block (loop-closure evaluation).
    """
    pitch = block + street

    def xy(i, j):
        return [i * pitch, j * pitch]

    lo, hi = margin_blocks, n_blocks - margin_blocks
    if route == "lap":
        c = n_blocks // 2
        return np.array([xy(c, c), xy(c + 1, c), xy(c + 1, c + 1),
                         xy(c, c + 1), xy(c, c), xy(c + 1, c)])
    wps = []
    j = lo
    direction = 1
    i0, i1 = lo, hi
    while j <= hi:
        a, b = (i0, i1) if direction > 0 else (i1, i0)
        wps.append(xy(a, j))
        wps.append(xy(b, j))
        j += 2
        direction *= -1
    # consecutive rows share their end column, so the polyline legs
    # alternate horizontal sweeps with vertical hops automatically
    return np.array(wps)
