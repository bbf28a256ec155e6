"""LOAM feature extraction on torch tensors (port of the JAX package's
``ops/features.py``, kernel branch).

RingImage -> curvature (11-tap filter), sectors, occlusion / parallel-beam
rejection, the sector-adaptive corner gate, all greedy pick rounds in one
kernel (``ops.pick_rounds``), and the five feature clouds. Every step runs
on the device of the ring image.
"""

from __future__ import annotations

from typing import Tuple

import torch

from msf_loam_tpu_torch.config import FeatureConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, RingImage, ScanFeatures
from msf_loam_tpu_torch.ops.pick_rounds import pick_rounds
from msf_loam_tpu_torch.ops.voxel import voxel_downsample_compact_idx

Tensor = torch.Tensor

_BIG = 1.0e18


def _sq3(v: Tensor) -> Tensor:
    """Sum of squares over the last axis of size 3, in x, y, z order."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 a*b + c rounded once (a*b is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def compute_curvature(xyz: Tensor, mask: Tensor,
                      cfg: FeatureConfig) -> Tuple[Tensor, Tensor]:
    """11-point curvature per ring row and the margin-respecting
    eligibility: (R, W) float32 and (R, W) bool.

    The JAX reference's compiled program contracts the centre tap with the
    first shifted add, and the squared norm, into fused multiply-adds;
    ``_fma`` reproduces those roundings so the picks agree bit for bit."""
    m = cfg.edge_margin
    acc = _fma(torch.full_like(xyz, -(2 * m + 1)), xyz,
               torch.roll(xyz, m, dims=1))
    for s in range(-m + 1, m + 1):
        acc = acc + torch.roll(xyz, -s, dims=1)
    ax, ay, az = acc.unbind(-1)
    curv = _fma(az, az, _fma(ay, ay, ax * ax))
    n_valid = mask.sum(dim=1, keepdim=True)
    idx = torch.arange(xyz.shape[1], device=xyz.device)[None, :]
    eligible = (idx >= m) & (idx <= n_valid - m - 1) & mask
    return curv, eligible


def _prefix_sum_lanes(x: Tensor) -> Tensor:
    """Inclusive prefix sum along the last axis by log-depth shifted adds
    (integer, exact)."""
    n = x.shape[-1]
    d = 1
    while d < n:
        shifted = torch.zeros_like(x)
        shifted[..., d:] = x[..., :n - d]
        x = x + shifted
        d *= 2
    return x


def assign_sectors(eligible: Tensor, n_valid: Tensor,
                   cfg: FeatureConfig) -> Tensor:
    """Sector id per position ([margin, n-margin-1] split into equal parts),
    -1 where ineligible: (R, W) int32."""
    m = cfg.edge_margin
    span = torch.clamp(n_valid[:, None] - 2 * m, min=1)
    idx = torch.arange(eligible.shape[1], device=eligible.device)[None, :]
    sector = torch.div((idx - m) * cfg.num_sectors, span, rounding_mode="floor")
    sector = torch.clamp(sector, 0, cfg.num_sectors - 1)
    return torch.where(eligible, sector, -1).to(torch.int32)


def unreliable_mask(xyz: Tensor, mask: Tensor, cfg: FeatureConfig) -> Tensor:
    """Occluded-boundary ("veil") and parallel-beam rejection: (R, W) bool,
    True where a point must not anchor a feature."""
    r = torch.where(mask, torch.sqrt(_sq3(xyz)), torch.zeros_like(xyz[..., 0]))
    r_next = torch.roll(r, -1, dims=1)
    both_valid = mask & torch.roll(mask, -1, dims=1)
    far_here = both_valid & (r - r_next > cfg.occlusion_gap)
    far_next = both_valid & (r_next - r > cfg.occlusion_gap)
    block = torch.zeros_like(mask)
    for j in range(0, cfg.edge_margin + 1):
        block = block | torch.roll(far_here, -j, dims=1)
    for j in range(1, cfg.edge_margin + 2):
        block = block | torch.roll(far_next, j, dims=1)
    d_prev = (torch.roll(r, 1, dims=1) - r).abs()
    d_next = (r_next - r).abs()
    parallel = (d_prev > cfg.parallel_frac * r) & \
               (d_next > cfg.parallel_frac * r) & mask & \
               torch.roll(mask, 1, dims=1) & torch.roll(mask, -1, dims=1)
    return block | parallel


def corner_gate_array(curv: Tensor, eligible: Tensor, sector: Tensor,
                      cfg: FeatureConfig) -> Tensor:
    """Sector-adaptive corner gate (R, W): max(curvature_threshold,
    corner_gate_factor x the sector's smooth-population mean curvature)."""
    S = cfg.num_sectors
    s_oh = sector[:, None, :] == torch.arange(S, device=curv.device)[None, :, None]
    smooth = eligible & (curv < cfg.curvature_threshold)
    w_sm = (s_oh & smooth[:, None, :]).float()
    sec_mean = (torch.einsum("rsw,rw->rs", w_sm, curv)
                / torch.clamp(w_sm.sum(dim=2), min=1.0))
    gate_rs = torch.clamp(cfg.corner_gate_factor * sec_mean,
                          min=cfg.curvature_threshold)
    gate = gate_rs[:, 0:1].expand(sector.shape)
    for s in range(1, S):
        gate = torch.where(sector == s, gate_rs[:, s:s + 1], gate)
    return gate


def _gap_sq(xyz: Tensor) -> Tensor:
    """g[i] = ||x[i+1] - x[i]||^2 along the ring (last column huge)."""
    g = _sq3(torch.roll(xyz, -1, dims=1) - xyz)
    g[:, -1] = _BIG
    return g


def run_pick_rounds(curv: Tensor, pickable: Tensor, sector: Tensor,
                    gap: Tensor, corner_gate_arr: Tensor, cfg: FeatureConfig):
    """All three pick phases in one kernel. Returns (corner_picks (20,R,S),
    flat_picks (4,R,S), suppressed-after-corner-phases (R, W))."""
    neg = torch.full((), -_BIG, device=curv.device)
    score_c = torch.where(pickable & (curv > corner_gate_arr), curv, neg)
    score_f = torch.where(pickable & (curv < cfg.curvature_threshold),
                          -curv, neg)
    bad = (gap > cfg.neighbor_gap_sq).to(torch.int32)
    cb0 = _prefix_sum_lanes(bad) - bad
    return pick_rounds(
        score_c.contiguous(), score_f.contiguous(), sector.contiguous(),
        cb0.contiguous(), S=cfg.num_sectors, nsup=cfg.neighbor_suppress,
        n_sharp=cfg.sharp_per_sector,
        n_rest=cfg.less_sharp_per_sector - cfg.sharp_per_sector, rest_T=6,
        n_flat=cfg.flat_per_sector)


def _gather_picks(xyz: Tensor, rel: Tensor, picks: Tensor, n_keep: int,
                  B: int) -> PointBatch:
    """Gather pick rounds 0..n_keep-1 of (B*R, W) ring rows into B lanes of
    R * n_keep * S points each (row, round, sector order; rings numbered
    within the lane). The kernel returns at least n_keep rounds of each
    kind (its corner rounds round the rest up to whole rounds of T)."""
    BR, S = picks.shape[1], picks.shape[2]
    R, n = BR // B, n_keep
    sel = picks[:n]                                        # (n, B*R, S)
    w_idx = sel.permute(1, 0, 2).reshape(BR, n * S).long()
    valid = w_idx >= 0
    w_safe = torch.clamp(w_idx, min=0)
    p_xyz = torch.gather(xyz, 1, w_safe[..., None].expand(-1, -1, 3))
    p_rel = torch.gather(rel, 1, w_safe)
    ring = torch.arange(R, dtype=torch.int32, device=picks.device) \
        .repeat(B)[:, None].expand(w_idx.shape)
    return PointBatch(p_xyz.reshape(B, R * n * S, 3),
                      p_rel.reshape(B, R * n * S), ring.reshape(B, R * n * S),
                      valid.reshape(B, R * n * S))


def extract_features_batched(imgs: RingImage, scan_time: Tensor,
                             cfg: FeatureConfig) -> ScanFeatures:
    """``extract_features`` over B lanes (RingImage leaves (B, R, W, ...))
    in one set of launches. Every stage up to the less-flat filter works
    along one ring row, so the lanes are flattened into B*R rows (one
    pick_rounds launch); only the less-flat voxel compaction stays
    lane-local (a sort per lane). Each lane's clouds equal
    ``extract_features`` of that lane bit for bit. Returns ScanFeatures
    whose clouds carry a leading (B,) axis; ``time`` is ``scan_time``."""
    B, R, W, _ = imgs.xyz.shape
    S = cfg.num_sectors
    xyz = imgs.xyz.reshape(B * R, W, 3)
    rel = imgs.rel_time.reshape(B * R, W)
    mask = imgs.mask.reshape(B * R, W)

    curv, eligible = compute_curvature(xyz, mask, cfg)
    n_valid = mask.sum(dim=1)
    sector = assign_sectors(eligible, n_valid, cfg)
    gap = _gap_sq(xyz)
    pickable = eligible & ~unreliable_mask(xyz, mask, cfg)
    gate = corner_gate_array(curv, eligible, sector, cfg)

    corner_picks, flat_picks, suppressed = run_pick_rounds(
        curv, pickable, sector, gap, gate, cfg)

    sharp = _gather_picks(xyz, rel, corner_picks, cfg.sharp_per_sector, B)
    less_sharp = _gather_picks(xyz, rel, corner_picks,
                               cfg.less_sharp_per_sector, B)
    flat = _gather_picks(xyz, rel, flat_picks, cfg.flat_per_sector, B)

    # less-flat: everything eligible that is not a corner pick / neighbour
    less_flat_mask = (eligible & ~suppressed).reshape(B, R * W)
    lf_ring = torch.arange(R, dtype=torch.int32, device=xyz.device)[:, None] \
        .expand(R, W).reshape(1, R * W).expand(B, R * W)
    full = PointBatch(imgs.xyz.reshape(B, R * W, 3),
                      imgs.rel_time.reshape(B, R * W), lf_ring,
                      imgs.mask.reshape(B, R * W))
    lf_idx, lf_valid = voxel_downsample_compact_idx(
        full.xyz, less_flat_mask, cfg.less_flat_leaf, cfg.max_less_flat,
        salt=lf_ring if cfg.less_flat_per_ring else None)
    return ScanFeatures(time=scan_time, full=full, corner_sharp=sharp,
                        corner_less_sharp=less_sharp, surf_flat=flat,
                        surf_less_flat=full.take(lf_idx, lf_valid))


def extract_features(ring_image: RingImage, scan_time: Tensor,
                     cfg: FeatureConfig) -> ScanFeatures:
    """RingImage -> five feature clouds (2 sharp / 20 less-sharp / 4 flat
    per ring-sector; the less-flat cloud voxel-downsampled): the batched
    extraction on one lane."""
    feats = extract_features_batched(RingImage(*(a[None] for a in ring_image)),
                                     scan_time, cfg)
    return feats._replace(**{f: getattr(feats, f).lane(0)
                             for f in ScanFeatures._fields[1:]})
