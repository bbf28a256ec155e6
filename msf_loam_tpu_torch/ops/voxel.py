"""Voxel-grid downsampling as one stable sort (torch port of the JAX
package's ``ops/voxel.py``), plus the integer helpers the voxel map shares.

Bit-parity rules with the JAX package:

* the uint32 hash runs in int64 with a ``& 0xFFFFFFFF`` mask after every
  product, and is reinterpreted as int32 at the end;
* float -> uint32 / int32 conversions saturate and send NaN to 0, as
  XLA's conversions do;
* a scale given as a Python float (a config constant: the less-flat leaf,
  the mapping leaves, the cell size) multiplies by its float32
  reciprocal, and a scale given as a tensor (a map's leaf or cell size)
  divides, exactly as the reference's compiled program does (XLA rewrites
  division by a constant into multiplication by its reciprocal). One
  differing rounding moves a point across a voxel boundary;
* stable sorts replace ``lax.sort``; a two-key sort packs
  ``ckey << 32 | (lkey + 2**31)`` into one int64 key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_MASK32 = 0xFFFFFFFF
_I32_MIN = -2 ** 31


def div_scale(x: Tensor, scale) -> Tensor:
    """x / scale as the reference computes it: times the float32
    reciprocal for a Python-float scale, IEEE division for a tensor."""
    if isinstance(scale, Tensor):
        return x / scale
    recip = float(np.float32(1.0) / np.float32(scale))
    return x * torch.full((), recip, dtype=x.dtype, device=x.device)


def sat_u32(x: Tensor) -> Tensor:
    """Saturating float -> uint32 (values in int64), NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return x.clamp(-1.0, 4294967296.0).long().clamp(0, _MASK32)


def sat_i32(x: Tensor) -> Tensor:
    """Saturating float -> int32 (values in int64), NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0)
    return x.clamp(-2147483648.0, 2147483648.0).long().clamp(
        _I32_MIN, 2 ** 31 - 1)


def as_i32(u: Tensor) -> Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def hash3_u32(u: Tensor) -> Tensor:
    """(p0*P1) ^ (p1*P2) ^ (p2*P3) mod 2**32 over (..., 3) uint32 values
    held in int64; returns int64 in [0, 2**32)."""
    return (((u[..., 0] * _P1) & _MASK32) ^ ((u[..., 1] * _P2) & _MASK32)
            ^ ((u[..., 2] * _P3) & _MASK32))


def salt_key(key: Tensor, salt: Optional[Tensor]) -> Tensor:
    """key ^ (salt * 40503) in int32 arithmetic."""
    if salt is None:
        return key
    return (key.long() ^ (salt.long() * 40503)).to(torch.int32)


def voxel_keys(xyz: Tensor, leaf, origin: float = 4096.0) -> Tensor:
    """Hashed int32 voxel keys of points (N, 3)."""
    ijk = torch.floor(div_scale(xyz + origin, leaf))
    return as_i32(hash3_u32(sat_u32(ijk)))


def _first_kept(keep: Tensor, capacity: int) -> Tensor:
    """Ascending positions of the first ``capacity`` True entries along the
    last axis, padded with 2**30 (the ``top_k(-posval)`` of the JAX
    version, scatter form)."""
    n = keep.shape[-1]
    rank = torch.cumsum(keep, -1) - 1
    dest = torch.where(keep & (rank < capacity), rank, capacity)
    p = torch.full(keep.shape[:-1] + (capacity + 1,), 2 ** 30,
                   dtype=torch.int64, device=keep.device)
    p.scatter_(-1, dest, torch.arange(n, device=keep.device).expand_as(dest))
    return p[..., :capacity]


def _first_of_runs(sorted_keys: Tensor) -> Tensor:
    """True where a sorted key differs from its predecessor (last axis)."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[..., 1:] = sorted_keys[..., 1:] != sorted_keys[..., :-1]
    return first


def voxel_downsample_compact_idx(xyz: Tensor, mask: Tensor, leaf,
                                 capacity: int,
                                 salt: Optional[Tensor] = None):
    """Voxel dedup + front compaction in one sort: (idx (..., capacity)
    int64, valid (..., capacity) bool) of one representative (lowest index)
    per occupied voxel, in voxel-key order, padded with 0. Leading axes of
    ``xyz`` (..., n, 3) are independent lanes (each sorts alone)."""
    n = xyz.shape[-2]
    capacity = min(capacity, n)
    key = salt_key(voxel_keys(xyz, leaf), salt).long()
    iota = torch.arange(n, device=xyz.device)
    key = torch.where(mask, key, iota + _I32_MIN)
    ks, order = torch.sort(key, dim=-1, stable=True)
    p = _first_kept(_first_of_runs(ks) & torch.gather(mask, -1, order),
                    capacity)
    valid = p < 2 ** 30
    idx = torch.gather(order, -1, torch.clamp(p, max=n - 1))
    return torch.where(valid, idx, 0), valid


def voxel_downsample_grouped_idx(xyz: Tensor, mask: Tensor, leaf,
                                 capacity: int, world_xyz: Tensor,
                                 cell_size, group_budget: int):
    """``voxel_downsample_compact_idx`` whose output is also grouped by the
    map octant base cell ``floor((w - cell/2) / cell)`` of each point's
    world position, packed exactly (10 bits per axis, relative to the first
    point's cell). Returns (idx, valid, gid (..., capacity) ascending group
    ids with ``group_budget - 1`` as the overflow/invalid group, rep_pos
    (..., group_budget) first output row of each group). Leading axes are
    independent lanes."""
    n = xyz.shape[-2]
    capacity = min(capacity, n)
    G = group_budget
    dev = xyz.device

    lkey = voxel_keys(xyz, leaf).long()
    iota = torch.arange(n, device=dev)
    base = torch.floor(div_scale(world_xyz - 0.5 * cell_size, cell_size))
    ref = base[..., 0:1, :]
    ref = torch.where(torch.isfinite(ref), ref, torch.zeros_like(ref))
    rel = torch.nan_to_num(torch.clamp(base - ref, -512.0, 511.0),
                           nan=0.0).long() + 512
    ckey = (rel[..., 0] << 20) | (rel[..., 1] << 10) | rel[..., 2]
    ckey = torch.where(mask, ckey, 2 ** 30 + iota)
    lkey = torch.where(mask, lkey, iota + _I32_MIN)

    packed = (ckey << 32) | (lkey - _I32_MIN)
    ps, order = torch.sort(packed, dim=-1, stable=True)
    p = _first_kept(_first_of_runs(ps) & torch.gather(mask, -1, order),
                    capacity)
    valid = p < 2 ** 30
    pc = torch.clamp(p, max=n - 1)
    idx = torch.gather(order, -1, pc)

    ck_out = torch.gather(ps >> 32, -1, pc)
    gid = torch.cumsum(_first_of_runs(ck_out), -1) - 1
    gid = torch.where(valid, torch.clamp(gid, max=G - 1), G - 1)
    opos = torch.arange(capacity, device=dev)
    rep_pos = torch.full(valid.shape[:-1] + (G,), capacity,
                         dtype=torch.int64, device=dev)
    rep_pos = rep_pos.scatter_reduce(-1, gid, torch.where(valid, opos,
                                                          capacity),
                                     "amin", include_self=True)
    rep_pos = torch.clamp(rep_pos, max=capacity - 1)
    return torch.where(valid, idx, 0), valid, gid, rep_pos
