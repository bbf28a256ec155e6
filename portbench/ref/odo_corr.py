"""Fused scan-to-scan correspondence reductions: ``csrc/odo_corr.cu`` on a
CUDA tensor, the plain PyTorch version below on a CPU tensor.

Replaces the Pallas kernel ``msf_loam_tpu/ops/odo_corr.py``
(``odo_corr_pallas``). Per query: the global nearest reference point
(min, first argmin, ring), the nearest point on a different nearby ring,
and for K > 0 the (min, first argmin, ring) of each of K contiguous bins
of the reference cloud. Distances are exact float32 ``dx^2+dy^2+dz^2``.
Masked reference points sit at the 1e9 coordinate sentinel with ring 1e6;
the cloud is padded with the same sentinels to a multiple of K*128 (128
when K = 0), exactly as the Pallas wrapper pads it. The kernel splits the
cloud into slices over the blocks of a thread-block cluster and merges
their minima in slice order (see the note at the head of the source).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


Tensor = torch.Tensor

_INF = 3.0e38


class OdoCorr(NamedTuple):
    """Per query; a leading (B,) lane axis on every field when the call
    was batched."""
    a_d2: Tensor      # (N,)
    a_idx: Tensor     # (N,) int32
    a_ring: Tensor    # (N,) int32 ring of the nearest neighbour
    c_d2: Tensor      # (N,) nearest different-nearby-ring
    c_idx: Tensor     # (N,) int32 (M_padded when there is none)
    cand_d2: Tensor   # (N, K)
    cand_idx: Tensor  # (N, K) int32
    cand_ring: Tensor  # (N, K) int32


def ref_planes(ref_xyz: Tensor, ref_mask: Tensor, ref_ring: Tensor,
               K: int) -> Tensor:
    """(4, M_padded) f32 planes [x | y | z | ring] with the sentinels
    ((B, 4, M_padded) for (B, M, 3) lanes, each padded alike)."""
    pad_m = (-ref_xyz.shape[-2]) % (K * 128 if K else 128)
    xyz = torch.where(ref_mask[..., None], ref_xyz.to(torch.get_default_dtype()),
                      torch.full((), 1e9, device=ref_xyz.device))
    ring = torch.where(ref_mask, ref_ring.to(torch.get_default_dtype()),
                       torch.full((), 1e6, device=ref_xyz.device))
    planes = torch.cat([xyz.transpose(-1, -2), ring[..., None, :]], dim=-2)
    if pad_m:
        fill = torch.full(planes.shape[:-1] + (pad_m,), 1e9,
                          device=ref_xyz.device)
        fill[..., 3, :] = 1e6
        planes = torch.cat([planes, fill], dim=-1)
    return planes.contiguous()


def odo_corr_plain(q: Tensor, planes: Tensor, K: int,
                   nearby: float) -> OdoCorr:
    """Plain PyTorch version over the (N, M) distance matrix (per lane for
    (B, N, 3) queries and (B, 4, M) planes). ``min`` over a dim returns
    the first index of the minimum on every device."""
    M = planes.shape[-1]
    rx, ry, rz, rring = planes.unbind(-2)
    dx = rx[..., None, :] - q[..., 0:1]
    dy = ry[..., None, :] - q[..., 1:2]
    dz = rz[..., None, :] - q[..., 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    a_d2, a_idx = d2.min(dim=-1)
    ring_a = torch.gather(rring, -1, a_idx)
    dr = (rring[..., None, :] - ring_a[..., None]).abs()
    d2w = torch.where((dr > 0) & (dr <= nearby), d2,
                      torch.full((), _INF, device=q.device))
    c_d2, c_idx = d2w.min(dim=-1)
    c_idx = torch.where(c_d2 < _INF, c_idx, M)
    if K:
        cand_d2, cand_idx = d2.unflatten(-1, (K, M // K)).min(dim=-1)
        cand_idx = cand_idx + torch.arange(K, device=q.device) * (M // K)
        cand_ring = torch.gather(rring, -1, cand_idx.flatten(-2)) \
            .view(cand_idx.shape).to(torch.int32)
    else:
        cand_d2 = q.new_zeros(q.shape[:-1] + (0,))
        cand_idx = cand_ring = torch.zeros(q.shape[:-1] + (0,),
                                           dtype=torch.int32, device=q.device)
    return OdoCorr(a_d2, a_idx.to(torch.int32), ring_a.to(torch.int32),
                   c_d2, c_idx.to(torch.int32), cand_d2,
                   cand_idx.to(torch.int32), cand_ring)


def odo_corr_planes(q: Tensor, planes: Tensor, K: int,
                    nearby: float) -> OdoCorr:
    """Kernel entry on prepared planes (see ``ref_planes``): q (N, 3) and
    planes (4, M), or B lanes q (B, N, 3) and planes (B, 4, M) in one
    launch."""
    return odo_corr_plain(q, planes, K, nearby)


def odo_corr(q_world: Tensor, ref_xyz: Tensor, ref_mask: Tensor,
             ref_ring: Tensor, *, K: int = 16, nearby: float = 2.5) -> OdoCorr:
    """Fused correspondence reductions of one query cloud (N, 3) against
    one reference cloud, or of B lanes ((B, N, 3) against (B, M, 3)) in
    one launch; K = 0 skips the candidate bins (the edge path)."""
    planes = ref_planes(ref_xyz, ref_mask, ref_ring, K)
    return odo_corr_planes(q_world.to(torch.get_default_dtype()).contiguous(), planes, K, nearby)
