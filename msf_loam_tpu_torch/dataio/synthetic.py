"""Synthetic LiDAR world and scan simulator (numpy).

A copy of the part of the JAX package's ``dataio/synthetic.py`` that the
port's smoke run, tests and fixture writers drive: the corridor world
(floor, four walls, vertical poles), the NSH-style campus world, the
spinning multi-ring ray caster (``simulate_scans`` casts a sequence of
scans, optionally in a process pool), and the ground-vehicle paths with their
exact kinematic state and IMU stream. The numpy arithmetic is unchanged,
so one seed gives byte-identical scans and IMU samples in both packages.
"""

from __future__ import annotations

import dataclasses
import functools
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
    def corridor(seed: int = 0, n_poles: int = 24, size: float = 40.0) -> "World":
        """A room: floor + 4 walls + scattered poles (edge features)."""
        rng = np.random.default_rng(seed)
        s = size
        planes = [
            Plane(np.array([0.0, 0.0, -2.0]), np.array([0.0, 0.0, 1.0]), s * 2),
            Plane(np.array([s, 0.0, 0.0]), np.array([-1.0, 0.0, 0.0]), s * 2),
            Plane(np.array([-s, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), s * 2),
            Plane(np.array([0.0, s, 0.0]), np.array([0.0, -1.0, 0.0]), s * 2),
            Plane(np.array([0.0, -s, 0.0]), np.array([0.0, 1.0, 0.0]), s * 2),
        ]
        poles = []
        for _ in range(n_poles):
            xy = rng.uniform(-s * 0.8, s * 0.8, size=2)
            if np.linalg.norm(xy) < 4.0:
                continue  # keep the sensor start area clear
            poles.append(Pole(np.array([xy[0], xy[1], -2.0])))
        return World(planes, poles)

    @staticmethod
    def nsh_campus(seed: int = 0, sensor_height: float = 1.2) -> "World":
        """Indoor corridor -> outdoor courtyard campus scene (the zero-egress
        stand-in for the reference's NSH indoor-outdoor validation bag,
        README.md:40-43: a handheld VLP-16 walked through a building out
        into a courtyard and back).

        Geometry: a 30 m corridor (3 m wide, 3.2 m ceiling) opening through
        a doorway into a ~40x60 m courtyard enclosed by segmented building
        facades, with tree/lamp poles. Wall segments carry depth jitter
        (door recesses -> vertical corner features); the indoor->outdoor
        transition flips the feature regime (ceiling+close walls vs ground
        +far facades), which is exactly what the NSH sequence stresses.
        Sensor height ~1.2 m (handheld)."""
        rng = np.random.default_rng(seed)
        z0, z1 = -sensor_height, 3.2 - sensor_height   # floor / ceiling
        planes = [Plane(np.array([35.0, 0.0, z0]),
                        np.array([0.0, 0.0, 1.0]), 200.0)]
        rects: List[RectPlane] = []
        X = np.array([1.0, 0.0, 0.0])
        Y = np.array([0.0, 1.0, 0.0])

        def seg_wall(axis_pt0, axis_pt1, fixed, axis, normal_sign, zc, zh,
                     seg_len=4.0, jitter=0.15):
            """Depth-jittered wall segments along ``axis`` at ``fixed``."""
            n_seg = max(1, int(round((axis_pt1 - axis_pt0) / seg_len)))
            cuts = np.linspace(axis_pt0, axis_pt1, n_seg + 1)
            for k in range(n_seg):
                depth = rng.uniform(-jitter, jitter)
                c = np.zeros(3)
                c[axis] = 0.5 * (cuts[k] + cuts[k + 1])
                c[1 - axis] = fixed + normal_sign * depth
                c[2] = zc
                normal = np.zeros(3)
                normal[1 - axis] = float(normal_sign)
                u = X if axis == 0 else Y
                rects.append(RectPlane(center=c, normal=normal, u=u.copy(),
                                       half_u=0.5 * (cuts[k + 1] - cuts[k]),
                                       half_v=zh))

        zc_in = 0.5 * (z0 + z1)
        zh_in = 0.5 * (z1 - z0)
        # corridor x in [0, 30]: side walls (inward normals), end wall, ceiling
        seg_wall(0.0, 30.0, 1.5, axis=0, normal_sign=-1, zc=zc_in, zh=zh_in,
                 seg_len=3.0)
        seg_wall(0.0, 30.0, -1.5, axis=0, normal_sign=+1, zc=zc_in, zh=zh_in,
                 seg_len=3.0)
        rects.append(RectPlane(center=np.array([0.0, 0.0, zc_in]),
                               normal=X.copy(), u=Y.copy(),
                               half_u=1.8, half_v=zh_in))
        rects.append(RectPlane(center=np.array([15.0, 0.0, z1]),
                               normal=np.array([0.0, 0.0, -1.0]), u=X.copy(),
                               half_u=15.0, half_v=1.8))
        # building front facade at x=30 (outward +x), doorway gap |y|<=2
        zh_b = 5.0
        zc_b = zh_b + z0
        seg_wall(2.0, 40.0, 30.0, axis=1, normal_sign=+1, zc=zc_b, zh=zh_b)
        seg_wall(-40.0, -2.0, 30.0, axis=1, normal_sign=+1, zc=zc_b, zh=zh_b)
        # courtyard enclosure: far building x=70 (-x), sides y=+-30
        seg_wall(-40.0, 40.0, 70.0, axis=1, normal_sign=-1, zc=zc_b, zh=zh_b)
        seg_wall(30.0, 70.0, 30.0, axis=0, normal_sign=-1, zc=zc_b, zh=zh_b)
        seg_wall(30.0, 70.0, -30.0, axis=0, normal_sign=+1, zc=zc_b, zh=zh_b)
        # courtyard trees/lamps, kept clear of the walk route (y=0 and y=22
        # corridors plus the x=34 / x=62 cross legs)
        poles: List[Pole] = []
        while len(poles) < 40:
            x = rng.uniform(32.0, 68.0)
            y = rng.uniform(-28.0, 28.0)
            if (abs(y) < 2.5 or abs(y - 22.0) < 2.5
                    or abs(x - 34.0) < 2.5 or abs(x - 62.0) < 2.5):
                continue
            poles.append(Pole(np.array([x, y, z0]), radius=0.14,
                              height=float(rng.uniform(3.0, 6.0))))
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


def _scan_at(world: World, frame: tuple) -> Tuple[np.ndarray, np.ndarray]:
    t_world, R_world, kwargs = frame
    return simulate_scan(world, t_world, R_world, **kwargs)


def simulate_scans(world: World, frames: List[tuple], pool=None
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``simulate_scan(world, t_world, R_world, **kwargs)`` for each
    ``(t_world, R_world, kwargs)`` of ``frames``, in order. ``pool`` (a
    ``concurrent.futures`` process pool) casts them in its processes, with
    the same results: each scan depends only on its own arguments."""
    cast = functools.partial(_scan_at, world)
    return list(map(cast, frames) if pool is None else pool.map(cast, frames))


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


def synthetic_imu(path: VehiclePath, speed: float, t0: float, t1: float,
                  rate: float = 400.0, gravity: float = 9.81,
                  accel_noise: float = 0.0, gyro_noise: float = 0.0,
                  seed: int = 0, accel: float = None):
    """Exact body-frame IMU stream for a drive.

    Specific force = R^T (a_world + G) with a_world = tangential (speed
    ramp) + centripetal (omega x v); gyro = [0, 0, yaw_rate]. Matches the
    ImuData convention of imu/buffer.py (reference: types.h:6-10).
    """
    rng = np.random.default_rng(seed)
    times = np.arange(t0, t1, 1.0 / rate)
    st = drive_states(path, speed, times, accel=accel)
    a_world = st["accel_world"]
    G = np.array([0.0, 0.0, gravity])
    accel_body = np.einsum("nij,nj->ni", st["R"].transpose(0, 2, 1),
                           a_world + G[None])
    gyro_body = np.zeros((len(times), 3))
    gyro_body[:, 2] = st["yaw_rate"]  # planar: body z == world z
    if accel_noise > 0:
        accel_body = accel_body + rng.normal(scale=accel_noise,
                                             size=accel_body.shape)
    if gyro_noise > 0:
        gyro_body = gyro_body + rng.normal(scale=gyro_noise,
                                           size=gyro_body.shape)
    return times, accel_body, gyro_body
