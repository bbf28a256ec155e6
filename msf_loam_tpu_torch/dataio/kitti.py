"""KITTI odometry dataset reader and KITTI-format fixture writer.

The port's copy of the JAX package's ``dataio/kitti.py``: velodyne
``.bin`` frames, ``times.txt``, ground-truth ``poses/XX.txt`` and the
``Tr`` velodyne->camera calibration, with ground truth moved into the
lidar frame as the reference's ``kitti_helper`` does (``Tl = Tr^-1 Tc
Tr``). KITTI bins carry no ring field; rings come from elevation angles.

``KittiSequence.ring_images`` reads and preprocesses frames on the native
C++ prefetcher (``msf_loam_tpu_torch.runtime``, off the Python thread)
when it builds, else with numpy, and yields ``RingImage``s on the
requested device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np
import torch

from msf_loam_tpu_torch.dataio.preprocess import infer_rings_from_elevation


@dataclasses.dataclass
class KittiFrame:
    index: int
    time: float
    xyz: np.ndarray         # (N, 3) float32, lidar frame
    intensity: np.ndarray   # (N,)
    ring: np.ndarray        # (N,) int32 (inferred)
    gt_pose: Optional[np.ndarray]  # (4, 4) lidar-frame GT, or None


class KittiSequence:
    def __init__(self, dataset_folder: str, sequence: str,
                 n_rings: int = 64):
        self.root = dataset_folder
        self.seq = sequence
        self.n_rings = n_rings
        seq_dir = os.path.join(dataset_folder, "sequences", sequence)
        self.velodyne_dir = os.path.join(seq_dir, "velodyne")
        self.times = self._read_times(os.path.join(seq_dir, "times.txt"))
        self.Tr = self._read_calib(os.path.join(seq_dir, "calib.txt"))
        poses_file = os.path.join(dataset_folder, "poses", f"{sequence}.txt")
        self.gt_poses = (self._read_poses(poses_file)
                         if os.path.exists(poses_file) else None)
        # set by ring_images: whether the native prefetcher feeds it
        self.native: Optional[bool] = None

    @staticmethod
    def _read_times(path: str) -> np.ndarray:
        with open(path) as f:
            return np.asarray([float(line) for line in f if line.strip()])

    @staticmethod
    def _read_calib(path: str) -> np.ndarray:
        """Tr (velodyne -> cam0) as a 4x4."""
        with open(path) as f:
            for line in f:
                if line.startswith("Tr:"):
                    vals = np.asarray([float(x) for x in line[3:].split()])
                    T = np.eye(4)
                    T[:3, :4] = vals.reshape(3, 4)
                    return T
        raise ValueError(f"no 'Tr:' line in {path}")

    def _read_poses(self, path: str) -> np.ndarray:
        """(N, 4, 4) ground-truth poses in the lidar frame: Tr^-1 Tc Tr."""
        rows = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                vals = np.asarray([float(x) for x in line.split()])
                T = np.eye(4)
                T[:3, :4] = vals.reshape(3, 4)
                rows.append(T)
        Tc = np.asarray(rows)
        Tr_inv = np.linalg.inv(self.Tr)
        return np.einsum("ij,njk,kl->nil", Tr_inv, Tc, self.Tr)

    def __len__(self) -> int:
        return len(self.times)

    def read_frame(self, i: int) -> KittiFrame:
        path = os.path.join(self.velodyne_dir, f"{i:06d}.bin")
        data = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        xyz = data[:, :3]
        ring = infer_rings_from_elevation(xyz, self.n_rings)
        return KittiFrame(
            index=i, time=float(self.times[i]), xyz=xyz,
            intensity=data[:, 3], ring=ring,
            gt_pose=None if self.gt_poses is None else self.gt_poses[i],
        )

    def frames(self, start: int = 0, end: Optional[int] = None
               ) -> Iterator[KittiFrame]:
        end = len(self) if end is None else min(end, len(self))
        for i in range(start, end):
            yield self.read_frame(i)

    def ring_images(self, width: int, min_range: float = 0.3,
                    scan_period: float = 0.1, end: Optional[int] = None,
                    n_threads: int = 3, device="cuda"):
        """Iterate preprocessed (index, time, RingImage on ``device``),
        from the native C++ prefetcher when it builds (read and ingest off
        the Python thread), else from numpy; ``self.native`` says which."""
        from msf_loam_tpu_torch import runtime
        from msf_loam_tpu_torch.core.pointcloud import RingImage
        from msf_loam_tpu_torch.dataio import preprocess as pp

        end = len(self) if end is None else min(end, len(self))
        self.native = runtime.available()
        if self.native:
            pf = runtime.Prefetcher(self.velodyne_dir, end, self.n_rings,
                                    width, min_range, scan_period,
                                    n_threads=n_threads)
            try:
                for idx, xyz, rel, mask, _ in pf:
                    yield idx, float(self.times[idx]), RingImage(*(
                        torch.from_numpy(a).to(device)
                        for a in (xyz, rel, mask)))
            finally:
                pf.close()
        else:
            for f in self.frames(0, end):
                xyz, ring = pp.remove_invalid_points(f.xyz, min_range,
                                                     (f.ring,))
                rel = pp.compute_relative_time(xyz, ring, scan_period)
                planes = pp.build_ring_image_np(xyz, ring, rel, self.n_rings,
                                                width)
                yield f.index, f.time, RingImage(*(
                    torch.from_numpy(a).to(device) for a in planes))


def write_kitti_frame(path: str, xyz: np.ndarray,
                      intensity: Optional[np.ndarray] = None) -> None:
    """Write a KITTI-format .bin (used by tests and tools to make data)."""
    n = xyz.shape[0]
    out = np.zeros((n, 4), np.float32)
    out[:, :3] = xyz
    if intensity is not None:
        out[:, 3] = intensity
    out.tofile(path)


def make_synthetic_kitti_sequence(root: str, sequence: str, n_frames: int,
                                  world=None, n_rings: int = 16,
                                  pts_per_ring: int = 1800,
                                  step: Optional[np.ndarray] = None,
                                  yaw_rate: float = 0.0,
                                  pool=None) -> None:
    """Write a KITTI-format sequence from the synthetic world (the same
    files, byte for byte, as the JAX package writes from the same
    arguments). ``pool`` (a ``concurrent.futures`` process pool) ray-casts
    the scans in its processes; the files are the same."""
    from msf_loam_tpu_torch.dataio import synthetic

    world = world or synthetic.World.corridor(seed=0, size=12.0)
    step = np.array([0.25, 0.0, 0.0]) if step is None else step
    seq_dir = os.path.join(root, "sequences", sequence)
    os.makedirs(os.path.join(seq_dir, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)

    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        for name in ["P0", "P1", "P2", "P3"]:
            f.write(f"{name}: " + " ".join(["0"] * 12) + "\n")
        eye = np.eye(4)[:3, :4].reshape(-1)
        f.write("Tr: " + " ".join(str(x) for x in eye) + "\n")

    times, poses, frames = [], [], []
    for i in range(n_frames):
        yaw = yaw_rate * 0.1 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        t = step * i
        frames.append((t, R, dict(n_rings=n_rings, pts_per_ring=pts_per_ring,
                                  noise=0.004, seed=i)))
        times.append(0.1 * i)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses.append(T[:3, :4].reshape(-1))
    scans = synthetic.simulate_scans(world, frames, pool)
    for i, (xyz, _) in enumerate(scans):
        write_kitti_frame(
            os.path.join(seq_dir, "velodyne", f"{i:06d}.bin"), xyz)

    with open(os.path.join(seq_dir, "times.txt"), "w") as f:
        f.write("\n".join(f"{t:.6f}" for t in times) + "\n")
    with open(os.path.join(root, "poses", f"{sequence}.txt"), "w") as f:
        for p in poses:
            f.write(" ".join(f"{x:.9f}" for x in p) + "\n")
