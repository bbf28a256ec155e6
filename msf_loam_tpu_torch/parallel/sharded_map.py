"""The voxel hash map with its slots split over the mesh ``map`` axis
(port of the JAX package's ``parallel/sharded_map.py``).

Rank r owns hash slots [r H/D, (r+1) H/D) of an H-slot map and holds only
those, as a local ``VoxelHashMap`` of H/D slots (the global table size is
the local one times the axis size):

* insert: every rank sees the whole scan, keeps the points whose slot it
  owns and inserts them at local slot ids; no communication (the scatter
  is the routing);
* evict: per slot, per rank; no communication;
* query: the queries are replicated; each rank takes the top-k of its own
  slots among each query's 8 octant slabs (slots it does not own are
  masked), the per-rank candidate sets are exchanged in one all-gather of
  a packed buffer, and every rank merges them with a top-k, rank-major as
  JAX concatenates them. k-NN is associative under a top-k merge, so the
  result is the dense map's answer.

Top-k takes the lower index on ties (a stable sort), within a rank and in
the merge, as ``lax.top_k`` does; rows with fewer than k candidates fill
with d2 = 3e38 and ``valid = d2 < 1e37``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from msf_loam_tpu_torch.parallel.mesh import Axis, Mesh
from msf_loam_tpu_torch.slam import voxel_map as vm
from msf_loam_tpu_torch.slam.voxel_map import VoxelHashMap

Tensor = torch.Tensor


def _span(mesh: Mesh, local: VoxelHashMap) -> Tuple[Axis, int, int]:
    """(map axis, global table size, first global slot of this rank)."""
    ax = mesh.axis("map")
    h = local.table_size
    return ax, h * ax.size, ax.index * h


def create_sharded_map(mesh: Mesh, table_size: int, slab_capacity: int,
                       cell_size: float, leaf: float) -> VoxelHashMap:
    """This rank's shard of an empty ``table_size``-slot map."""
    n = mesh.axis("map").size
    if table_size % n:
        raise ValueError(
            f"map_table_size={table_size} must divide evenly over the "
            f"{n}-way 'map' mesh axis (got remainder {table_size % n}); "
            f"slot ownership ranges would misalign with the sharded layout")
    return vm.create_map(table_size // n, slab_capacity, cell_size, leaf,
                         device=mesh.device)


def sharded_insert(mesh: Mesh, local: VoxelHashMap, xyz: Tensor,
                   mask: Tensor) -> VoxelHashMap:
    """Insert world points into the rank's shard: the points whose slot it
    owns, at local slot ids."""
    _, H, lo = _span(mesh, local)
    slot = vm._hash_cells(vm.cells_of(local, xyz), H)
    own = (slot >= lo) & (slot < lo + local.table_size)
    return vm.insert_at_slots(local, xyz, mask & own, slot - lo)


def sharded_evict_far(mesh: Mesh, local: VoxelHashMap, center: Tensor,
                      radius: float) -> VoxelHashMap:
    """Drop the shard's points beyond ``radius`` of ``center``."""
    return vm.evict_far(local, center, radius)


def map_points(mesh: Mesh, *maps: VoxelHashMap) -> Tensor:
    """Stored points of each whole map (int64, one all-reduce)."""
    local = torch.stack([m.count.long().sum() for m in maps])
    return mesh.axis("map").all_reduce(local)


def gather_map(mesh: Mesh, local: VoxelHashMap) -> VoxelHashMap:
    """The whole map on every rank (one all-gather a field), for
    artifacts and checks."""
    ax = mesh.axis("map")

    def full(x):
        g = ax.all_gather(x)
        return g.reshape((-1,) + tuple(x.shape[1:]))

    return local._replace(points=full(local.points),
                          leaf_key=full(local.leaf_key),
                          count=full(local.count), n_obs=full(local.n_obs))


def _local_topk(mesh: Mesh, local: VoxelHashMap, q: Tensor, ks, radii_sq
                ) -> List[Tuple[Tensor, Tensor]]:
    """The rank's top-k of its own slots among the 8 octant slabs, at one
    or two radii: [(d2 (Q, k), xyz (Q, k, 3)), ...]."""
    _, H, lo = _span(mesh, local)
    cand, occup, d2 = vm.octant_candidates(local.points, local.count,
                                           local.cell_size, q, H, lo)
    return [vm.top_k(d2, occup & (d2 <= r2), cand, k)
            for k, r2 in zip(ks, radii_sq)]


def _exchange(ax: Axis, parts: List[Tuple[Tensor, Tensor, Tensor]]):
    """One all-gather of every (d2, xyz) set packed flat, then the merge
    top-k of each on every rank: [(d2, xyz, valid), ...] with ``valid``
    also masked by the set's query mask."""
    buf = torch.cat([t.reshape(-1) for d2, xyz, _ in parts
                     for t in (d2, xyz)])
    allb = ax.all_gather(buf)                                  # (D, L)
    out, o = [], 0
    for d2, xyz, qmask in parts:
        Q, k = d2.shape
        n = Q * k
        d2s = allb[:, o:o + n].reshape(-1, Q, k)
        xyzs = allb[:, o + n:o + 4 * n].reshape(-1, Q, k, 3)
        o += 4 * n
        d2m = d2s.permute(1, 0, 2).reshape(Q, -1)              # rank-major
        xyzm = xyzs.permute(1, 0, 2, 3).reshape(Q, -1, 3)
        top, txyz = vm.top_k(d2m, torch.ones_like(d2m, dtype=torch.bool),
                             xyzm, k)
        out.append((top, txyz, (top < 1e37) & qmask[:, None]))
    return out


def sharded_query_knn(mesh: Mesh, local: VoxelHashMap, query: Tensor,
                      query_mask: Tensor, k: int = 5):
    """``voxel_map.query_knn`` against the sharded map (one all-gather)."""
    r2s, _ = vm.radii_sq(local.cell_size)
    (d2, xyz), = _local_topk(mesh, local, query, (k,), (r2s,))
    return _exchange(mesh.axis("map"), [(d2, xyz, query_mask)])[0]


def sharded_query_knn_2r(mesh: Mesh, local: VoxelHashMap, query: Tensor,
                         query_mask: Tensor, k: int = 5, k2: int = 16):
    """``voxel_map.query_knn_2r`` against the sharded map (one
    all-gather)."""
    r2s, r2w = vm.radii_sq(local.cell_size)
    (d2, xyz), (d2w, xyzw) = _local_topk(mesh, local, query, (k, k2),
                                         (r2s, r2w))
    s, w = _exchange(mesh.axis("map"), [(d2, xyz, query_mask),
                                        (d2w, xyzw, query_mask)])
    return s + w


def sharded_query_pair(mesh: Mesh, corner_map: VoxelHashMap,
                       surf_map: VoxelHashMap, qc: Tensor, qc_mask: Tensor,
                       qs: Tensor, qs_mask: Tensor, k: int = 5, k2: int = 16):
    """One association round: corner k-NN and surface two-radius k-NN in
    one packed all-gather. Returns (sel_corner, sel_surf) shaped as
    ``sharded_query_knn`` and ``sharded_query_knn_2r`` return them."""
    r2c, _ = vm.radii_sq(corner_map.cell_size)
    r2s, r2w = vm.radii_sq(surf_map.cell_size)
    (cd2, cxyz), = _local_topk(mesh, corner_map, qc, (k,), (r2c,))
    (sd2, sxyz), (wd2, wxyz) = _local_topk(mesh, surf_map, qs, (k, k2),
                                           (r2s, r2w))
    c, s, w = _exchange(mesh.axis("map"), [(cd2, cxyz, qc_mask),
                                           (sd2, sxyz, qs_mask),
                                           (wd2, wxyz, qs_mask)])
    return c, s + w
