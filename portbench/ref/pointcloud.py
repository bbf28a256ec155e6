"""Fixed-shape point-cloud containers (torch mirrors of the JAX package's
``core/pointcloud.py``): masked point batches, the five-cloud scan product
and the ring-organised range image. Shapes stay static so every frame
allocates the same tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.ref.se3 import Pose

Tensor = torch.Tensor


class PointBatch(NamedTuple):
    """A masked batch of LiDAR points."""

    xyz: Tensor        # (N, 3) float32
    rel_time: Tensor   # (N,)  float32
    ring: Tensor       # (N,)  int32
    mask: Tensor       # (N,)  bool

    def transform(self, pose: Pose) -> "PointBatch":
        return self._replace(xyz=pose.apply(self.xyz))

    def masked_xyz(self, fill: float = 1e6) -> Tensor:
        """xyz with invalid rows pushed far away (so nearest-neighbour
        searches ignore them)."""
        return torch.where(self.mask[..., None], self.xyz,
                           torch.full_like(self.xyz, fill))

    def take(self, idx: Tensor, mask: Tensor) -> "PointBatch":
        """Rows ``idx`` with a new validity mask; a batch with a leading
        lane axis takes ``idx`` (B, n) per lane."""
        if idx.dim() == 1:
            return PointBatch(self.xyz[idx], self.rel_time[idx],
                              self.ring[idx], mask)
        return PointBatch(
            torch.gather(self.xyz, -2, idx[..., None].expand(
                idx.shape + (3,))),
            torch.gather(self.rel_time, -1, idx),
            torch.gather(self.ring, -1, idx), mask)

    def lane(self, b: int) -> "PointBatch":
        """Lane ``b`` of a batch with a leading lane axis."""
        return PointBatch(*(a[b] for a in self))


class ScanFeatures(NamedTuple):
    """The five feature clouds of one scan."""

    time: Tensor
    full: PointBatch
    corner_sharp: PointBatch
    corner_less_sharp: PointBatch
    surf_flat: PointBatch
    surf_less_flat: PointBatch

    def lane(self, b: int) -> "ScanFeatures":
        """Lane ``b`` of features with a leading lane axis."""
        return ScanFeatures(self.time[b] if self.time.dim() else self.time,
                            *(pb.lane(b) for pb in self[1:]))


class RingImage(NamedTuple):
    """Range-image organised scan: points grouped per ring, azimuth-ordered,
    front-packed."""

    xyz: Tensor       # (R, W, 3)
    rel_time: Tensor  # (R, W)
    mask: Tensor      # (R, W) bool
