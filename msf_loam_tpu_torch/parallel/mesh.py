"""The (data, map) mesh of the distributed port (the counterpart of the
JAX package's ``parallel/mesh.py``) and its counted collectives.

JAX lays work over a ``Mesh`` of devices in one process and lets XLA
insert the collectives of ``shard_map``. The port runs one process per
rank and issues them itself: ``Mesh`` holds the process group, the rank,
the world size, the (data, map) shape and the rank's device, and every
collective of the distributed modules goes through ``Axis.all_reduce`` /
``Axis.all_gather``, which count in ``COLLECTIVES``.

Axes, as in JAX:

* ``map``  — the voxel map's hash slots (and the odometry query rows);
* ``data`` — correspondence rows and pose-graph segments.

The shape is (1, world) or (world, 1): one axis spans the whole group and
the other has size 1. A collective over an axis of size 1 in a larger
world is nothing and counts nothing; over an axis that spans the group it
is issued (and counted) at every world size, one included.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from msf_loam_tpu_torch.parallel import runtime

Tensor = torch.Tensor

COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: Optional[dist.ProcessGroup]   # None: the default group
    rank: int
    world_size: int
    n_data: int
    n_map: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "map": self.n_map}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def axis(self, name: str) -> "Axis":
        return Axis(self, name)


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis: its size, this rank's index on it, and the counted
    collectives over it."""
    mesh: Mesh
    name: str

    @property
    def size(self) -> int:
        return self.mesh.shape[self.name]

    @property
    def index(self) -> int:
        return self.mesh.rank if self.spans() else 0

    def spans(self) -> bool:
        """The axis is the whole group (collectives are issued)."""
        return self.size == self.mesh.world_size

    def all_reduce(self, buf: Tensor) -> Tensor:
        """Sum ``buf`` over the axis (in place) and return it."""
        if self.spans():
            dist.all_reduce(buf, group=self.mesh.group)
            COLLECTIVES["all_reduce"] += 1
        return buf

    def all_gather(self, buf: Tensor) -> Tensor:
        """Every rank's ``buf`` stacked in rank order: (size, *buf.shape)."""
        if not self.spans():
            return buf[None]
        buf = buf.contiguous()
        if self.mesh.backend == "nccl":
            out = buf.new_empty((self.size,) + tuple(buf.shape))
            dist.all_gather_into_tensor(out, buf, group=self.mesh.group)
        else:
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf, group=self.mesh.group)
            out = torch.stack(parts)
        COLLECTIVES["all_gather"] += 1
        return out


def make_mesh(n_map: Optional[int] = None, n_data: int = 1,
              group: Optional[dist.ProcessGroup] = None,
              device=None) -> Mesh:
    """A (data, map) mesh over the process group (the default group,
    started by ``runtime.initialize`` if it is not up). ``device`` is the
    rank's device: ``cuda:LOCAL_RANK`` by default, which raises without
    CUDA, or the one named (``"cpu"`` in the tests)."""
    dev = runtime.resolve_device(device)
    if group is None and not dist.is_initialized():
        runtime.initialize(device=dev)
    world = dist.get_world_size(group)
    if n_map is None:
        n_map = world // n_data
    if n_map * n_data != world:
        raise ValueError(f"a ({n_data}, {n_map}) mesh needs "
                         f"{n_map * n_data} ranks, the group has {world}")
    if n_map != 1 and n_data != 1:
        raise ValueError(f"the port's mesh is (1, world) or (world, 1); "
                         f"got ({n_data}, {n_map})")
    return Mesh(group=group, rank=dist.get_rank(group), world_size=world,
                n_data=n_data, n_map=n_map, device=dev)


def shard_over(mesh: Mesh, axis: str, x: Tensor) -> Tensor:
    """This rank's contiguous block of ``x``'s rows over ``axis``."""
    ax = mesh.axis(axis)
    n = x.shape[0] // ax.size
    return x[ax.index * n:(ax.index + 1) * n]


def replicated(mesh: Mesh, x: Tensor) -> Tensor:
    """``x`` as every rank holds it (replicated state is kept whole)."""
    return x
