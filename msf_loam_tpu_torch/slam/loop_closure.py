"""Loop closure: proximity detection, loop-edge measurement by scan
matching, and the exact loop-factor pose graph (port of the JAX package's
``slam/loop_closure.py``).

* detection: keyframe position proximity with an index-gap guard and
  non-max suppression (host-side numpy, once per optimisation), or
  appearance (``slam.scan_context``);
* relative-pose measurement: the scan-to-scan matcher
  (``slam.odometry``, kernels odo_corr and select_fit) re-targeted at the
  detected keyframe pair, or scan-to-map against a submap of the first
  keyframe's neighbourhood (kernel select_fit);
* optimisation: ``posegraph.optimize_with_loops``, the loop edges as
  Woodbury corrections to the block-Thomas solve (kernel block_tridiag).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from msf_loam_tpu_torch.config import MsfLoamConfig, PoseGraphConfig
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.slam import posegraph


@dataclasses.dataclass
class LoopEdge:
    frame_i: int
    frame_j: int
    rel_t: np.ndarray   # (3,) measured translation i->j
    rel_q: np.ndarray   # (4,) wxyz measured rotation i->j
    sigma_r: float = 0.01
    sigma_t: float = 0.1


def detect_loops(positions: np.ndarray, max_dist: float = 3.0,
                 min_index_gap: int = 20, max_loops: int = 8,
                 suppress_gap: int = 10) -> List[Tuple[int, int]]:
    """Proximity loop candidates: pairs (i, j) with ``j - i >=
    min_index_gap`` and ``||p_i - p_j|| < max_dist``, picked closest-first
    with non-max suppression so one revisit gives one edge.

    positions: (N, 3) trajectory estimate (drifted is fine: max_dist
    bounds the detectable drift)."""
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    if n < min_index_gap + 2:
        return []
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cand = (jj - ii >= min_index_gap) & (d < max_dist)
    order = np.argsort(d[cand])
    ci, cj = ii[cand][order], jj[cand][order]
    picked: List[Tuple[int, int]] = []
    for i, j in zip(ci, cj):
        if len(picked) >= max_loops:
            break
        if any(abs(i - pi) < suppress_gap and abs(j - pj) < suppress_gap
               for pi, pj in picked):
            continue
        picked.append((int(i), int(j)))
    return picked


def match_loop_pair(feats_i, feats_j, pose_i: Pose, pose_j: Pose,
                    cfg: MsfLoamConfig, guess: Optional[Pose] = None):
    """Measure the relative pose i->j by scan-matching keyframe j's
    features against keyframe i's, seeded with the current estimate (or
    ``guess``, e.g. scan context's yaw). Returns (rel pose i->j, ok) on
    the features' device."""
    from msf_loam_tpu_torch.slam import odometry

    if guess is None:
        # match_scan2scan estimates curr(j)-to-last(i): p_i = T · p_j
        guess = pose_i.inverse().compose(pose_j)
    result = odometry.match_scan2scan(feats_i, feats_j, guess, cfg.odometry)
    return result.pose_curr2last, result.ok


def match_loop_pair_submap(neighbors, feats_j, guess: Pose,
                           cfg: MsfLoamConfig, table_size: int = 1 << 12,
                           cell_capacity: int = 16):
    """Measure the loop relative pose by registering keyframe j against a
    submap built from keyframe i and its neighbours, in i's frame.

    neighbors: list of (ScanFeatures, Pose), the pose mapping that
    keyframe's sensor frame into keyframe i's frame (identity for i).
    Returns (rel pose i->j, ok)."""
    from msf_loam_tpu_torch.slam import mapping, voxel_map
    from msf_loam_tpu_torch.slam.pipeline import downsample_features

    mc = cfg.mapping
    dev = feats_j.corner_less_sharp.xyz.device
    cmap = voxel_map.create_map(table_size, cell_capacity, mc.map_cell_size,
                                mc.line_resolution, device=dev)
    smap = voxel_map.create_map(table_size, cell_capacity, mc.map_cell_size,
                                mc.plane_resolution, device=dev)
    for feats, rel in neighbors:
        cw = feats.corner_less_sharp.transform(rel)
        sw = feats.surf_less_flat.transform(rel)
        cmap = voxel_map.insert(cmap, cw.xyz, cw.mask)
        smap = voxel_map.insert(smap, sw.xyz, sw.mask)
    corner_ds = downsample_features(feats_j.corner_less_sharp,
                                    mc.line_resolution,
                                    mc.corner_query_points)
    surf_ds = downsample_features(feats_j.surf_less_flat,
                                  mc.plane_resolution, mc.max_query_points)
    res = mapping.match_scan2map(cmap, smap, corner_ds, surf_ds, guess, mc)
    return res.pose, res.ok


class SparsePoseGraph:
    """Keyframe pose graph with loop edges: ``add_edge`` collects loop
    constraints; ``optimize`` folds them into the trajectory exactly."""

    def __init__(self, pad_loops: int = 8) -> None:
        self.edges: List[LoopEdge] = []
        self.pad_loops = pad_loops

    def add_edge(self, edge: LoopEdge) -> None:
        self.edges.append(edge)

    def optimize(self, poses: Pose, data: posegraph.PoseGraphData,
                 cfg: Optional[PoseGraphConfig] = None,
                 n_iters: int = 10) -> posegraph.PoseGraphResult:
        """Chain + GPS + collected loop edges, exact Woodbury GN solve on
        the poses' device."""
        cfg = cfg or PoseGraphConfig()
        dev = poses.t.device
        n_pad = max(self.pad_loops, len(self.edges))
        e = self.edges
        meas = Pose(
            t=torch.as_tensor(np.reshape([x.rel_t for x in e], (-1, 3)),
                              dtype=torch.float32, device=dev),
            q=torch.as_tensor(np.reshape([x.rel_q for x in e], (-1, 4)),
                              dtype=torch.float32, device=dev))
        loops = posegraph.LoopFactors.pad(
            np.asarray([x.frame_i for x in e], np.int64),
            np.asarray([x.frame_j for x in e], np.int64), meas, to_l=n_pad)
        return posegraph.optimize_with_loops(poses, data, loops, cfg,
                                             n_iters=n_iters)
