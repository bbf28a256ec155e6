"""Fixed-capacity spatial-hash voxel map (port of the JAX package's
``slam/voxel_map.py``: create, insert, evict, the one-level planar and the
grouped octant gathers).

* ``points``   (H, P, 3) — slab of up to P points per hash slot; unoccupied
  entries hold ``EMPTY_COORD`` in every component (an invariant kept by
  create/insert/evict, so the candidate gather needs no occupancy mask);
* ``leaf_key`` (H, P) int32 — hashed leaf-voxel id per stored point;
* ``count``    (H,) int32 — occupancy per slot;
* ``n_obs``    (H, P) float32 — observations per stored point.

The map functions return new tensors and leave their input map intact, as
the JAX package's do (an insert copies the ~21 MB table of a shipping-size
map once).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from msf_loam_tpu_torch.ops.voxel import (as_i32, div_scale, hash3_u32,
                                          salt_key, sat_i32, sat_u32)

Tensor = torch.Tensor

EMPTY_COORD = 1.0e9


class VoxelHashMap(NamedTuple):
    points: Tensor     # (H, P, 3) float32
    leaf_key: Tensor   # (H, P) int32
    count: Tensor      # (H,) int32
    n_obs: Tensor      # (H, P) float32
    cell_size: float
    leaf: float

    @property
    def table_size(self) -> int:
        return self.points.shape[0]

    @property
    def slab_capacity(self) -> int:
        return self.points.shape[1]

    def total_points(self) -> Tensor:
        return self.count.sum()


class QueryGroups(NamedTuple):
    """Base-cell grouping of a query batch: ascending per-query group ids
    and the first query row of each group (the last group is the
    overflow/invalid sentinel)."""
    gid: Tensor       # (Q,)
    rep_pos: Tensor   # (G,)


def create_map(table_size: int, slab_capacity: int, cell_size: float,
               leaf: float, device="cuda") -> VoxelHashMap:
    return VoxelHashMap(
        points=torch.full((table_size, slab_capacity, 3), EMPTY_COORD,
                          dtype=torch.float32, device=device),
        leaf_key=torch.full((table_size, slab_capacity), -1,
                            dtype=torch.int32, device=device),
        count=torch.zeros((table_size,), dtype=torch.int32, device=device),
        n_obs=torch.zeros((table_size, slab_capacity), dtype=torch.float32,
                          device=device),
        cell_size=float(cell_size), leaf=float(leaf))


def _hash_cells(cells: Tensor, table_size: int) -> Tensor:
    """(..., 3) int32-valued cell coords -> slot index in [0, table_size)
    (int64). A negative cell hashes as its two's-complement uint32."""
    return hash3_u32(cells & 0xFFFFFFFF) % table_size


def _f32(x: float, like: Tensor) -> Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _leaf_key_dyn(xyz: Tensor, leaf: float, origin: float = 8192.0) -> Tensor:
    ijk = torch.floor(div_scale(xyz + origin, _f32(leaf, xyz)))
    return as_i32(hash3_u32(sat_u32(ijk)))


def _dedup_batch(xyz: Tensor, mask: Tensor, leaf: float,
                 salt: Optional[Tensor] = None) -> Tensor:
    """One representative (lowest index) per (salted) leaf voxel in the
    batch."""
    n = xyz.shape[0]
    iota = torch.arange(n, device=xyz.device)
    key = salt_key(_leaf_key_dyn(xyz, leaf), salt).long()
    key = torch.where(mask, key, iota - 2 ** 31)
    ks, order = torch.sort(key, stable=True)
    first = torch.ones_like(mask)
    first[1:] = ks[1:] != ks[:-1]
    keep = torch.zeros_like(mask)
    keep[order] = first
    return keep & mask


def insert(vmap: VoxelHashMap, xyz: Tensor, mask: Tensor) -> VoxelHashMap:
    """Insert world-frame points, one representative per leaf voxel: the
    first observation of a leaf voxel is kept, full slabs drop overflow."""
    return insert_at_slots(vmap, xyz, mask,
                           _hash_cells(cells_of(vmap, xyz), vmap.table_size))


def cells_of(vmap: VoxelHashMap, xyz: Tensor) -> Tensor:
    """Map cell coordinates of points: floor(xyz / cell_size), the cell
    size dividing as a tensor (the map's leaf in the reference)."""
    return sat_i32(torch.floor(div_scale(xyz, _f32(vmap.cell_size, xyz))))


def insert_at_slots(vmap: VoxelHashMap, xyz: Tensor, mask: Tensor,
                    slot: Tensor, leaf_salt: Optional[Tensor] = None
                    ) -> VoxelHashMap:
    """Insert with caller-provided slot ids. Rows that are not written
    (duplicates, masked, slab overflow) go to one scratch row appended past
    the flattened table and cut off again.

    ``leaf_salt`` (per-point int32) separates the leaf-voxel namespaces of
    logically distinct maps sharing one table (the batched pipeline salts
    by lane), so one lane's point never suppresses another lane's insert
    in the same world voxel."""
    H, P = vmap.table_size, vmap.slab_capacity
    n = xyz.shape[0]
    dev = xyz.device

    rep = _dedup_batch(xyz, mask, vmap.leaf, salt=leaf_salt)
    lkey = salt_key(_leaf_key_dyn(xyz, vmap.leaf), leaf_salt)
    slot = torch.clamp(slot.long(), 0, H - 1)
    slot = torch.where(mask, slot, H - 1)

    count_at = vmap.count[slot].long()                       # (n,)
    occup = torch.arange(P, device=dev)[None, :] < count_at[:, None]
    match = (vmap.leaf_key[slot] == lkey[:, None]) & occup
    keep = rep & ~match.any(dim=1)

    # rank new points within their slot (stable) to get write offsets
    key = torch.where(keep, slot, H)
    ks, order = torch.sort(key, stable=True)
    pos = torch.arange(n, device=dev)
    is_start = torch.ones_like(keep)
    is_start[1:] = ks[1:] != ks[:-1]
    seg_start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - seg_start

    dest = count_at + rank
    ok = keep & (dest < P)
    # dropped rows (not ok) write into a scratch row past the table
    w_flat = torch.where(ok, slot * P + dest, H * P)
    flat_pts = torch.cat([vmap.points.view(H * P, 3), xyz.new_empty((1, 3))])
    flat_pts.index_copy_(0, w_flat, xyz)
    new_points = flat_pts[:H * P].view(H, P, 3)
    flat_keys = torch.cat([vmap.leaf_key.view(-1), lkey.new_empty(1)])
    flat_keys.index_copy_(0, w_flat, lkey)
    flat_obs = torch.cat([vmap.n_obs.view(-1), vmap.n_obs.new_empty(1)])
    flat_obs.index_copy_(0, w_flat, torch.ones(n, device=dev))
    count = vmap.count.long().index_add(0, slot, ok.long())
    count = torch.clamp(count, max=P).to(torch.int32)
    return vmap._replace(points=new_points,
                         leaf_key=flat_keys[:H * P].view(H, P),
                         count=count, n_obs=flat_obs[:H * P].view(H, P))


def evict_far(vmap: VoxelHashMap, center: Tensor,
              radius: float = 100.0) -> VoxelHashMap:
    """Drop stored points farther than ``radius`` from ``center`` (per
    point, not per slot) and re-compact every slab, kept points first in
    their stored order. ``center`` is one (3,) anchor or (H, 3) per-slot
    anchors (the batched pipeline's fused table evicts each lane's slots
    around that lane's pose)."""
    P = vmap.slab_capacity
    dev = vmap.points.device
    occup = torch.arange(P, device=dev)[None, :] < vmap.count[:, None]
    d = vmap.points - (center[None, None, :] if center.dim() == 1
                       else center[:, None, :])
    d2 = (d * d).sum(dim=-1)
    keep = occup & (d2 <= radius * radius)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    new_points = torch.gather(vmap.points, 1, order[..., None].expand(-1, -1, 3))
    new_keys = torch.gather(vmap.leaf_key, 1, order)
    new_nobs = torch.gather(vmap.n_obs, 1, order)
    new_count = keep.sum(dim=1).to(torch.int32)
    live = torch.arange(P, device=dev)[None, :] < new_count[:, None]
    new_keys = torch.where(live, new_keys, -1)
    new_points = torch.where(live[..., None], new_points,
                             torch.full((), EMPTY_COORD, device=dev))
    return vmap._replace(points=new_points, leaf_key=new_keys,
                         count=new_count, n_obs=new_nobs)


def neighbor_cells8(q: Tensor, cell_size: float) -> Tensor:
    """The 8 cells that can hold a point within cell_size/2 of q:
    (Q, 8, 3) int32-valued (int64) cell coords."""
    cf = div_scale(q, _f32(cell_size, q))
    base = torch.floor(cf)
    frac = cf - base
    low = sat_i32(base) + torch.where(frac < 0.5, -1, 0)
    # corner offsets of a 2x2x2 block, row i = bits (i>>2, i>>1, i) & 1
    i = torch.arange(8, device=q.device)
    off = torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], dim=1)
    return low[:, None, :] + off[None, :, :]


def gather_candidates_planar(vmap: VoxelHashMap, query: Tensor) -> Tensor:
    """One-level octant gather in planar (3, Q, 8P) layout: the 8 slabs
    around every query. Unoccupied entries hold EMPTY_COORD by the table
    invariant; masked queries are not filtered (their callers AND the query
    mask into every validity gate)."""
    H, P = vmap.table_size, vmap.slab_capacity
    Q = query.shape[0]
    slots = _hash_cells(neighbor_cells8(query, vmap.cell_size), H)   # (Q, 8)
    cand = vmap.points.permute(2, 0, 1)[:, slots]                   # (3,Q,8,P)
    return cand.reshape(3, Q, 8 * P)


def gather_candidates_rows_grouped(vmap: VoxelHashMap, query: Tensor,
                                   gid: Tensor, rep_pos: Tensor) -> Tensor:
    """Two-level octant gather over base-cell grouped queries, in
    planar-packed row layout (Q, 3*8P): row q = [x*8P | y*8P | z*8P],
    EMPTY_COORD for empty entries and for the overflow group G-1. The 8
    slabs are gathered once per group and re-expanded per query."""
    H, P = vmap.table_size, vmap.slab_capacity
    Q = query.shape[0]
    G = rep_pos.shape[0]
    rep_w = query[torch.clamp(rep_pos, 0, Q - 1)]             # (G, 3)
    slots = _hash_cells(neighbor_cells8(rep_w, vmap.cell_size), H)  # (G, 8)
    grp = vmap.points.view(H, 3 * P)[slots]                   # (G, 8, 3P)
    grp = grp.view(G, 8, P, 3).permute(0, 3, 1, 2).reshape(G, 3 * 8 * P)
    grp[G - 1] = EMPTY_COORD
    return grp[torch.clamp(gid, 0, G - 1)]                    # (Q, 3*8P)
