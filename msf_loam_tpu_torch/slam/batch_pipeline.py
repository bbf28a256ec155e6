"""Multi-sequence batched SLAM on torch tensors (port of the JAX package's
``slam/batch_pipeline.py``): B trajectories through one set of launches
per frame.

The B per-lane hash maps fuse into one table of B*H slots (lane b owns
slots [b*H, (b+1)*H), its leaf keys salted by b), so map gathers and
inserts are single flat operations. Every other stage carries a leading
lane axis: the extraction runs the lanes' ring rows as one image (one
pick_rounds launch), the four odo_corr launches of the odometry cover all
lanes, each select_fit launch takes the lanes' queries as one row batch,
the downsample sorts every lane alone, and the Gauss-Newton solves run
batched over the lanes (``torch.func.vmap``). No Python loop runs over
the lanes inside a frame, so the launches per frame do not grow with B.

The frame follows the JAX ``_frame_fn``: no finite-pose watchdogs, the
scan-to-map rounds gated on ``n_corr >= 10`` per lane, odometry run on
frame 0 too (against the zero features of ``init_batch_state``) with an
identity step, the eviction on every ``map_evict_period``-th frame around
each lane's mapped position. ``frame_idx`` is a host integer, so nothing
inside a frame synchronises with the host. Not ported (the port's config
rejects ``motion_deskew``, and the port always groups its gathers and
selects on the kernel): the motion-deskew branches, the XLA fallback
branches, the ungrouped planar gather and ``_fused_query_2r``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from msf_loam_tpu_torch.config import MsfLoamConfig
from msf_loam_tpu_torch.core.pointcloud import RingImage, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose, select_pose
from msf_loam_tpu_torch.ops import features as feat_mod
from msf_loam_tpu_torch.ops import gauss_newton as gn
from msf_loam_tpu_torch.slam import odometry
from msf_loam_tpu_torch.slam import voxel_map as vm
from msf_loam_tpu_torch.slam.mapping import _CandidateCache, _sq_f32
from msf_loam_tpu_torch.slam.pipeline import downsample_features_grouped

Tensor = torch.Tensor


class BatchState(NamedTuple):
    corner_map: vm.VoxelHashMap   # fused table: (B*H, P, 3)
    surf_map: vm.VoxelHashMap
    prev_feats: ScanFeatures      # leading lane axis, full cloud stripped
    pose_c2l: Pose                # (B,) poses
    pose_odom: Pose
    pose_o2m: Pose
    frame_idx: int                # frames run (host integer)


def _identity(batch: int, device) -> Pose:
    q = torch.zeros((batch, 4), device=device)
    q[:, 0] = 1.0
    return Pose(torch.zeros((batch, 3), device=device), q)


def init_batch_state(cfg: MsfLoamConfig, batch: int, n_rings: int,
                     device="cuda") -> BatchState:
    """Empty fused maps, identity poses and the features of an empty scan
    for ``batch`` lanes, on ``device`` (the card by default; a machine
    without CUDA raises; pass ``device="cpu"`` to run the kernels' plain
    PyTorch versions)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_batch_state(device='cuda') needs a CUDA "
                           "device; pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels")
    mc, fc = cfg.mapping, cfg.features
    W = fc.max_points_per_ring
    empty = RingImage(torch.zeros((batch, n_rings, W, 3), device=device),
                      torch.zeros((batch, n_rings, W), device=device),
                      torch.zeros((batch, n_rings, W), dtype=torch.bool,
                                  device=device))
    feats0 = feat_mod.extract_features_batched(
        empty, torch.zeros(batch, device=device), fc)
    return BatchState(
        corner_map=vm.create_map(batch * mc.map_table_size,
                                 mc.map_cell_capacity, mc.map_cell_size,
                                 mc.line_resolution, device=device),
        surf_map=vm.create_map(batch * mc.map_table_size,
                               mc.map_cell_capacity, mc.map_cell_size,
                               mc.plane_resolution, device=device),
        prev_feats=feats0.strip_full(),
        pose_c2l=_identity(batch, device), pose_odom=_identity(batch, device),
        pose_o2m=_identity(batch, device), frame_idx=0)


def _lane_of_row(B: int, n: int, device) -> Tensor:
    """Lane id of each row of B lanes of n rows (lane-major)."""
    return torch.arange(B, device=device).repeat_interleave(n)


def _lane_slots(vmap: vm.VoxelHashMap, H: int, points: Tensor) -> Tensor:
    """(B*n, 8) fused-table slots of the octant cells around B lanes of n
    points: lane b's cells hash into [b*H, (b+1)*H)."""
    B, n, _ = points.shape
    slots = vm._hash_cells(vm.neighbor_cells8(points.reshape(B * n, 3),
                                              vmap.cell_size), H)
    return slots + (_lane_of_row(B, n, points.device) * H)[:, None]


def _fused_query(vmap: vm.VoxelHashMap, H: int, query: Tensor,
                 query_mask: Tensor, k: int):
    """k nearest stored points within cell/2 of each query (B, Q, 3), over
    the lane's slots of the fused table: (d2, xyz, valid) of shapes
    (B, Q, k), (B, Q, k, 3), (B, Q, k); ties to the lower candidate."""
    B, Q, _ = query.shape
    P = vmap.slab_capacity
    q = query.reshape(B * Q, 3)
    slots = _lane_slots(vmap, H, query)
    cand = vmap.points[slots]                                  # (BQ, 8, P, 3)
    occup = torch.arange(P, device=q.device) < vmap.count[slots][..., None]
    diff = cand - q[:, None, None, :]
    d2 = (diff * diff).sum(dim=-1)
    keep = occup & (d2 <= _sq_f32(vmap.cell_size * 0.5))
    d2 = torch.where(keep, d2, torch.full((), 3e38, device=q.device))
    top_d2, arg = torch.sort(d2.reshape(B * Q, 8 * P), dim=1, stable=True)
    top_d2, arg = top_d2[:, :k], arg[:, :k]
    top_xyz = torch.gather(cand.reshape(B * Q, 8 * P, 3), 1,
                           arg[..., None].expand(B * Q, k, 3))
    valid = (top_d2 < 1e37) & query_mask.reshape(-1)[:, None]
    return (top_d2.view(B, Q, k), top_xyz.view(B, Q, k, 3),
            valid.view(B, Q, k))


def _fused_insert(vmap: vm.VoxelHashMap, H: int, xyz: Tensor,
                  mask: Tensor) -> vm.VoxelHashMap:
    """Insert (B, N, 3) world points into the fused table, lane b into its
    slots, leaf keys salted by lane (one lane's point never suppresses
    another's insert in the same world voxel)."""
    B, N, _ = xyz.shape
    flat = xyz.reshape(B * N, 3)
    lane = _lane_of_row(B, N, xyz.device)
    slots = vm._hash_cells(vm.cells_of(vmap, flat), H) + lane * H
    return vm.insert_at_slots(vmap, flat, mask.reshape(-1), slots,
                              leaf_salt=lane)


def _fused_evict_far(vmap: vm.VoxelHashMap, H: int, centers: Tensor,
                     radius: float) -> vm.VoxelHashMap:
    """Per-lane far-point eviction over the fused table: slot b*H+h
    evicts around lane b's position ``centers[b]``."""
    return vm.evict_far(vmap, centers.repeat_interleave(H, dim=0), radius)


def _fused_gather_candidates_planar_grouped(vmap: vm.VoxelHashMap, H: int,
                                            query: Tensor, gid: Tensor,
                                            rep_pos: Tensor) -> Tensor:
    """Grouped two-level octant gather over the fused table: one slab
    fetch per (lane, base-cell group), re-expanded per query, in the
    select kernel's planar-packed rows layout (B*Q, 3*8P); EMPTY_COORD in
    every lane's overflow group G-1."""
    B, Q, _ = query.shape
    G = rep_pos.shape[1]
    P = vmap.slab_capacity
    rep = torch.clamp(rep_pos, 0, Q - 1)
    rep_w = torch.gather(query, 1, rep[..., None].expand(B, G, 3))
    slots = _lane_slots(vmap, H, rep_w)                            # (BG, 8)
    grp = vmap.points.view(-1, 3 * P)[slots]                     # (BG,8,3P)
    grp = grp.view(B * G, 8, P, 3).permute(0, 3, 1, 2).reshape(B, G, 24 * P)
    grp[:, G - 1] = vm.EMPTY_COORD
    cand = torch.gather(grp, 1, torch.clamp(gid, 0, G - 1)[..., None]
                        .expand(B, Q, 24 * P))
    return cand.view(B * Q, 24 * P)


def _batched_fused_associate(cache: _CandidateCache, corner_ds, surf_ds,
                             cw: Tensor, sw: Tensor, mc):
    """One re-association round of every lane: one select_fit pair launch
    over the B*Q corner and surface rows (the JAX package makes two)."""
    return cache.associate(corner_ds, surf_ds, cw, sw, mc)


def _batched_map_match(corner_map, surf_map, H: int, corner_ds, surf_ds,
                       poses: Pose, cfg: MsfLoamConfig, corner_groups,
                       surf_groups) -> Tuple[Pose, Tensor]:
    """2 re-association rounds x 6-iteration Gauss-Newton for all lanes;
    candidates gathered once per frame over the fused table. A lane's
    round is kept when it found at least 10 correspondences."""
    mc = cfg.mapping
    pose = poses
    cache = _CandidateCache(
        _fused_gather_candidates_planar_grouped(
            corner_map, H, pose.apply(corner_ds.xyz), corner_groups.gid,
            corner_groups.rep_pos),
        _fused_gather_candidates_planar_grouped(
            surf_map, H, pose.apply(surf_ds.xyz), surf_groups.gid,
            surf_groups.rep_pos),
        corner_map.cell_size, surf_map.cell_size)
    ok = None
    for _ in range(mc.outer_rounds):
        corr = _batched_fused_associate(cache, corner_ds, surf_ds,
                                        pose.apply(corner_ds.xyz),
                                        pose.apply(surf_ds.xyz), mc)
        n_corr = corr.edge_valid.sum(dim=1) + corr.plane_valid.sum(dim=1)
        out = gn.solve_edge_plane(pose, corr[:4], corr[4:], mc.huber_delta,
                                  mc.gn_iterations)
        ok = n_corr >= 10
        pose = select_pose(ok, out.pose, pose)
    return pose, ok


def _frame_fn(cfg: MsfLoamConfig, H: int, state: BatchState,
              imgs: RingImage, is_first: bool) -> Tuple[BatchState, Pose]:
    """One frame of every lane: ``imgs`` leaves (B, R, W, ...). Returns the
    new state and the (B,) mapped poses."""
    fc, oc, mc = cfg.features, cfg.odometry, cfg.mapping
    B = state.pose_odom.t.shape[0]
    dev = state.pose_odom.t.device
    feats = feat_mod.extract_features_batched(
        imgs, torch.zeros(B, device=dev), fc)

    odo = odometry.match_scan2scan(state.prev_feats, feats, state.pose_c2l,
                                   oc)
    if is_first:        # odometry still runs: the same launches every frame
        pose_c2l, step_pose = state.pose_c2l, _identity(B, dev)
    else:
        pose_c2l = select_pose(odo.ok, odo.pose_curr2last, state.pose_c2l)
        step_pose = pose_c2l
    pose_odom = state.pose_odom.compose(step_pose)
    guess = state.pose_o2m.compose(pose_odom)

    # grouping keys: per-lane world positions at the matcher's transform
    corner_ds, corner_groups = downsample_features_grouped(
        feats.corner_less_sharp, mc.line_resolution, mc.corner_query_points,
        guess.apply(feats.corner_less_sharp.xyz), mc.map_cell_size,
        mc.gather_groups)
    surf_ds, surf_groups = downsample_features_grouped(
        feats.surf_less_flat, mc.plane_resolution, mc.max_query_points,
        guess.apply(feats.surf_less_flat.xyz), mc.map_cell_size,
        mc.gather_groups)

    pose_map, ok = _batched_map_match(state.corner_map, state.surf_map, H,
                                      corner_ds, surf_ds, guess, cfg,
                                      corner_groups, surf_groups)
    pose_map = select_pose(ok, pose_map, guess)
    pose_o2m = pose_map.compose(pose_odom.inverse())

    corner_map = _fused_insert(state.corner_map, H,
                               pose_map.apply(corner_ds.xyz), corner_ds.mask)
    surf_map = _fused_insert(state.surf_map, H, pose_map.apply(surf_ds.xyz),
                             surf_ds.mask)
    if mc.map_evict_period > 0 and \
            (state.frame_idx + 1) % mc.map_evict_period == 0:
        corner_map = _fused_evict_far(corner_map, H, pose_map.t,
                                      mc.map_evict_radius)
        surf_map = _fused_evict_far(surf_map, H, pose_map.t,
                                    mc.map_evict_radius)

    return BatchState(corner_map=corner_map, surf_map=surf_map,
                      prev_feats=feats.strip_full(), pose_c2l=pose_c2l,
                      pose_odom=pose_odom, pose_o2m=pose_o2m,
                      frame_idx=state.frame_idx + 1), pose_map


def run_batch(cfg: MsfLoamConfig, state: BatchState,
              ring_images: RingImage) -> Tuple[BatchState, Pose]:
    """Process T frames for all B lanes on the state's device (the card
    unless ``init_batch_state`` was asked for the CPU). ``ring_images``
    leaves are (T, B, R, W, ...). Returns (final state, per-frame mapped
    poses with leaves (T, B, ...))."""
    H = cfg.mapping.map_table_size
    dev = state.pose_odom.t.device
    ts, qs = [], []
    for t in range(ring_images.xyz.shape[0]):
        img = RingImage(*(a[t].to(dev) for a in ring_images))
        state, pose_map = _frame_fn(cfg, H, state, img, state.frame_idx == 0)
        ts.append(pose_map.t)
        qs.append(pose_map.q)
    return state, Pose(torch.stack(ts), torch.stack(qs))
