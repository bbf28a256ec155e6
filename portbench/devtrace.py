"""Device traces from ``torch.profiler``, read from its raw events.

``record(False, device)`` records the card's operations only (kernels,
copies, fills: CUPTI activity, no host ops, shapes or stacks), which
leaves their device times as they are; ``record(True, device)`` adds the
host's ops, to say what the host did while the card idled. The raw events are read
directly, without the profiler's per-op tables, so a window of some
hundred thousand launches is read in seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_RUNTIME_PREFIXES = ("cuda", "cu", "Memcpy", "Memset")


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


MARKER = "spin_kernel"   # torch.cuda._sleep's kernel: the harness's marker


class Trace:
    """Device operations and host ops of one traced stretch. With
    ``marked``, the stretch holds the harness's marker kernel (``MARKER``)
    on the harness's CUDA stream: every operation on that stream (the
    harness's inputs) is left out of ``device_ops`` and kept in
    ``harness_ops``; a stretch without the marker raises."""

    def __init__(self, events, window_s: float, marked: bool = False):
        self.window_s = window_s
        dev, host = [], []
        for e in events:
            dur = _ns(e, "duration")
            if dur <= 0:
                continue
            if "CUDA" in str(e.device_type()):
                dev.append((e.name(), _ns(e, "start"), dur,
                            e.device_resource_id()))
            elif not e.name().startswith(_RUNTIME_PREFIXES):
                host.append((e.name(), _ns(e, "start"), dur))
        dev.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        self.harness_stream = None
        if marked:
            streams = {r[3] for r in dev if MARKER in r[0]}
            if len(streams) != 1:
                raise RuntimeError(f"the trace holds the harness's marker on "
                                   f"{len(streams)} streams, not 1")
            self.harness_stream = streams.pop()
        self.device_ops: List[Tuple[str, int, int]] = [
            r[:3] for r in dev if r[3] != self.harness_stream]
        self.harness_ops: List[Tuple[str, int, int]] = [
            r[:3] for r in dev if r[3] == self.harness_stream]
        self.host_ops: List[Tuple[str, int, int]] = host

    @property
    def n_ops(self) -> int:
        return len(self.device_ops)

    def device_s(self, name_part: Optional[str] = None) -> float:
        """Summed device time of the operations (whose name holds
        ``name_part``)."""
        return sum(d for n, _, d in self.device_ops
                   if name_part is None or name_part in n) * 1e-9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for _, s, d in self.device_ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s + d)
            else:
                out.append([s, s + d])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, int] = defaultdict(int)
        for name, _, d in self.device_ops:
            by[name[:64]] += d
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device operations, summed by the innermost
        host op running at each gap's middle (``host_python`` where no op
        ran)."""
        busy = self.busy_intervals()
        starts = np.array([s for _, s, _ in self.host_ops], dtype=np.int64)
        ends = np.array([s + d for _, s, d in self.host_ops],
                        dtype=np.int64)
        by: Dict[str, int] = defaultdict(int)
        for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
            gap = b - a
            if gap <= 0:
                continue
            mid = a + gap // 2
            j = bisect.bisect_right(starts, mid) - 1
            name = "host_python"
            for k in range(j, max(j - 256, -1), -1):
                if ends[k] >= mid:
                    name = self.host_ops[k][0]
                    break
            by[name[:64]] += gap
        return [[k, v * 1e-9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


@contextlib.contextmanager
def record(cpu: bool, device, marker=None):
    """Profile the block; the yielded list receives one ``Trace`` at its
    end. The card is synchronised at both ends, and the trace's window is
    the host time between them. ``marker``: run first, after the start;
    and again last: it issues the marker kernel on the harness's stream
    (see ``Trace``). On a
    CPU device (the tests) only host ops are recorded."""
    from torch.profiler import ProfilerActivity, profile
    card = device.type == "cuda"
    acts = ([ProfilerActivity.CUDA] if card else []) + \
        ([ProfilerActivity.CPU] if cpu or not card else [])
    out: List[Trace] = []
    prof = profile(activities=acts)
    if card:
        torch.cuda.synchronize(device)
    ta = time.perf_counter()
    prof.start()
    t0 = time.perf_counter()
    if marker is not None and card:
        marker()
    try:
        yield out
    finally:
        if card:
            if marker is not None:
                marker()
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
        prof.stop()
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    out.append(Trace(events, window, marker is not None and card))
    print(f"profiler: start {t0 - ta:.2f} s, stop {t1 - t0 - window:.2f} s, "
          f"read {time.perf_counter() - t1:.2f} s, {len(events)} events",
          file=sys.stderr)
