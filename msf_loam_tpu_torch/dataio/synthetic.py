"""Synthetic LiDAR world and scan simulator (numpy).

A copy of the part of the JAX package's ``dataio/synthetic.py`` that the
port's smoke run and tests drive: the corridor world (floor, four walls,
vertical poles) and the spinning multi-ring ray caster. The numpy
arithmetic is unchanged, so one seed gives byte-identical scans in both
packages.
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
