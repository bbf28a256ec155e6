"""Host-side IMU sample buffer and fixed-shape window slicing (a copy of
the JAX package's numpy-only ``imu/buffer.py``; the port keeps its own).

Slices the sorted sample stream to [start, end), adds phony boundary
samples so the integration window lines up with the lidar timestamps, and
logs when the lidar/IMU offset exceeds the gate. The window is padded to a
fixed size for ``imu.preintegration.preintegrate``.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

logger = logging.getLogger("msf_loam_tpu_torch")


@dataclasses.dataclass
class ImuWindow:
    """Padded integration window: sample k covers (t_{k-1}, t_k]."""

    dts: np.ndarray    # (S,) float32
    accs: np.ndarray   # (S, 3) float32
    gyrs: np.ndarray   # (S, 3) float32
    valid: np.ndarray  # (S,) bool


class ImuBuffer:
    """Append-only sorted IMU stream."""

    def __init__(self, capacity: int = 1 << 20):
        self._t = np.zeros(capacity, np.float64)
        self._acc = np.zeros((capacity, 3), np.float64)
        self._gyr = np.zeros((capacity, 3), np.float64)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def add(self, t: float, acc, gyr) -> None:
        if self._n > 0 and t <= self._t[self._n - 1]:
            logger.error("IMU timestamps not monotonic: %f <= %f",
                         t, self._t[self._n - 1])
        if self._n >= len(self._t):
            raise RuntimeError("ImuBuffer capacity exceeded")
        self._t[self._n] = t
        self._acc[self._n] = acc
        self._gyr[self._n] = gyr
        self._n += 1

    @property
    def times(self) -> np.ndarray:
        return self._t[: self._n]

    def window(self, start_time: float, end_time: float, max_samples: int,
               max_offset: float = 0.01) -> ImuWindow:
        """The preintegration window for [start_time, end_time]: a phony
        first sample at start_time carrying the first in-range reading, the
        in-range samples, and a phony last sample at end_time carrying the
        last in-range reading."""
        t = self.times
        si = int(np.searchsorted(t, start_time, side="left"))
        ei = int(np.searchsorted(t, end_time, side="left"))
        dts = np.zeros(max_samples, np.float32)
        accs = np.zeros((max_samples, 3), np.float32)
        gyrs = np.zeros((max_samples, 3), np.float32)
        valid = np.zeros(max_samples, bool)
        if si >= self._n or ei <= si:
            logger.warning("IMU window [%f, %f] empty", start_time, end_time)
            return ImuWindow(dts, accs, gyrs, valid)

        offset = t[si] - start_time
        if offset >= max_offset:
            logger.error("imu preintegration: lidar_imu_time_offset=%.4f "
                         "@ imu=%.4f lidar=%.4f", offset, t[si], start_time)

        seg_t = [start_time] + list(t[si:ei]) + [end_time]
        seg_acc = [self._acc[si]] + list(self._acc[si:ei]) + [self._acc[ei - 1]]
        seg_gyr = [self._gyr[si]] + list(self._gyr[si:ei]) + [self._gyr[ei - 1]]
        n = min(len(seg_t) - 1, max_samples)
        if len(seg_t) - 1 > max_samples:
            logger.warning("IMU window truncated: %d samples > cap %d",
                           len(seg_t) - 1, max_samples)
        for k in range(n):
            dts[k] = seg_t[k + 1] - seg_t[k]
            accs[k] = seg_acc[k + 1]
            gyrs[k] = seg_gyr[k + 1]
            valid[k] = True
        return ImuWindow(dts, accs, gyrs, valid)
