"""The drive of a configuration: its kinematics and the ring-image pool.

A configuration file names a world, a route, a drive and a sensor. From
them this module casts every frame of the drive once, noise-free, in a
process pool, and keeps the ring images under ``portbench/.cache/`` keyed
by a hash of those parameters (never by the run's seed): only the first
run of a configuration in a checkout casts. Each run then loads the pool,
and ``--seed`` draws the point noise.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import multiprocessing
import os
import shutil
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench import ringimage, world

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
GENERATOR_VERSION = 1
_KEYS = ("sensor", "world", "route", "drive", "frames", "ingest")


def make_world(wcfg: dict) -> world.World:
    if wcfg["kind"] == "street_grid":
        return world.World.street_grid(seed=wcfg["seed"],
                                       n_blocks=wcfg["n_blocks"])
    raise ValueError(f"unknown world kind {wcfg['kind']!r}")


def make_path(rcfg: dict) -> world.VehiclePath:
    if rcfg["kind"] != "street_tour":
        raise ValueError(f"unknown route kind {rcfg['kind']!r}")
    wps = world.street_route(n_blocks=rcfg["n_blocks"], route="tour")
    return world.VehiclePath.from_waypoints(wps,
                                            turn_radius=rcfg["turn_radius"])


def drive_states(cfg: dict) -> dict:
    """Exact kinematic state (p, R, v_world, yaw_rate, times) of every
    frame of the drive."""
    d = cfg["drive"]
    path = make_path(cfg["route"])
    times = np.arange(cfg["frames"]) * cfg["sensor"]["scan_period"]
    st = world.drive_states(path, d["speed"], times, accel=d["accel"])
    s_end = world.speed_profile(times[-1:], d["speed"], d["accel"])[0][0]
    if s_end > path.total_length:
        raise ValueError(f"route of {path.total_length:.1f} m is shorter "
                         f"than the {s_end:.1f} m drive")
    st["times"] = times
    return st


def cache_dir(cfg: dict) -> str:
    key = json.dumps({k: cfg[k] for k in _KEYS} | {"v": GENERATOR_VERSION},
                     sort_keys=True)
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join(CACHE, f"{cfg['name']}-{digest}")


def _cast(task):
    """Pool worker: one noise-free frame's ring image planes."""
    cfg, i, p, R, v, yaw_rate = task
    s, ing = cfg["sensor"], cfg["ingest"]
    kw = dict(linear_vel=v, yaw_rate=yaw_rate) if cfg["drive"]["distorted"] \
        else {}
    xyz, ring = world.simulate_scan(
        make_world(cfg["world"]), p, R, n_rings=s["rings"],
        pts_per_ring=s["pts_per_ring"], fov_up=s["fov_up"],
        fov_down=s["fov_down"], max_range=s["max_range"], noise=0.0,
        scan_period=s["scan_period"], **kw)
    return i, ringimage.ring_image(xyz, ring, s["rings"], ing["width"],
                                   ing["min_range"], s["scan_period"])


@contextlib.contextmanager
def _single_threaded_children():
    """One BLAS / OpenMP thread in each process spawned meanwhile: one
    process a core with a thread pool each casts several times slower."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def build(cfg: dict, workers: int) -> str:
    """Cast the drive into its cache directory unless it is there; returns
    the directory. Writes into a fixed sibling and renames it when done."""
    out = cache_dir(cfg)
    if os.path.isdir(out):
        return out
    tmp = out + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    st = drive_states(cfg)
    F, R, W = cfg["frames"], cfg["sensor"]["rings"], cfg["ingest"]["width"]
    arrays = {
        "xyz": np.lib.format.open_memmap(os.path.join(tmp, "xyz.npy"), "w+",
                                         np.float32, (F, R, W, 3)),
        "rel_time": np.lib.format.open_memmap(
            os.path.join(tmp, "rel_time.npy"), "w+", np.float32, (F, R, W)),
        "mask": np.lib.format.open_memmap(os.path.join(tmp, "mask.npy"),
                                          "w+", np.bool_, (F, R, W)),
    }
    tasks = [(cfg, i, st["p"][i], st["R"][i], st["v_world"][i],
              float(st["yaw_rate"][i])) for i in range(F)]
    with _single_threaded_children(), ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for i, planes in ex.map(_cast, tasks, chunksize=2):
            for name, a in zip(("xyz", "rel_time", "mask"), planes):
                arrays[name][i] = a
    for a in arrays.values():
        a.flush()
    del arrays
    os.replace(tmp, out)
    return out


def load(cfg: dict, workers: int) -> dict:
    """The pool's numpy arrays (xyz, rel_time, mask), cast first if the
    cache does not hold them."""
    d = build(cfg, workers)
    return {k: np.load(os.path.join(d, k + ".npy"))
            for k in ("xyz", "rel_time", "mask")}
