"""The yardstick of the kernels: the card's peaks, the bytes and operations
each hand-written kernel's algorithm needs for a call's shapes, and a
recorder that notes the shapes of every call while a stretch is traced.

The work functions are copied from ``chip_smoke.py`` (``pick_work``,
``odo_work``, ``select_work``), which set ``PERF.md``'s table of bounds:
each input byte read once, each output byte written once. A kernel's
roofline share is the sum of its calls' bounds over its measured device
time, where a call's bound is max(bytes / HBM bandwidth, operations /
float32 peak).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# device kernel name (a substring of the trace's name) of each kernel
KERNEL_NAMES = {"pick_rounds": "pick_rounds_kernel",
                "odo_corr": "odo_corr_kernel",
                "select_fit": "select_fit_kernel"}


def bound_s(nbytes: float, nops: float) -> float:
    """The least time the card can take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S)


def pick_work(R: int, W: int, n_sharp: int, n_rest: int, rest_T: int,
              n_flat: int, S: int) -> Tuple[int, int]:
    """(bytes, operations) of one pick_rounds call on (R, W) planes."""
    n_picks = n_sharp + -(-n_rest // rest_T) * rest_T + n_flat
    return R * W * 16 + R * W + n_picks * R * S * 4, R * W * n_picks


def odo_work(N: int, M: int, K: int, B: int = 1) -> Tuple[int, int]:
    """(bytes, operations) of one odo_corr call over B lanes."""
    return B * (N * 12 + M * 16 + N * (5 + 3 * K) * 4), B * N * M * 15


def select_work(N: int, C: int, k: int, mode: str) -> Tuple[int, int]:
    """(bytes, operations) of one select_fit problem of N queries with C
    candidates each."""
    return (N * C * 3 * 4 + N * 12 + N * (k + 7) * 4,
            N * C * ({"line": 40, "plane": 50, "plane2": 90}[mode] + k))


class Recorder:
    """Bounds (seconds) of every kernel call made while it is active."""

    # the program's entry point that each kernel's calls pass through
    ENTRY_POINTS = {"pick_rounds": ("msf_loam_tpu_torch.ops.features",
                                    "pick_rounds"),
                    "odo_corr": ("msf_loam_tpu_torch.ops.odo_corr",
                                 "odo_corr_planes"),
                    "select_fit": ("msf_loam_tpu_torch.ops.select_fit",
                                   "_run")}

    def __init__(self):
        self.bounds: Dict[str, List[float]] = {k: [] for k in KERNEL_NAMES}
        self.missing: Dict[str, str] = {}

    def add(self, kernel: str, work: Tuple[int, int]) -> None:
        self.bounds[kernel].append(bound_s(*work))

    @contextlib.contextmanager
    def active(self):
        """Wrap the program's kernel entry points while the block runs. An
        entry point that is not there any more is noted in ``missing``:
        its kernel then reads no bound, and ``share`` refuses to read a
        kernel that still ran."""
        makers = {"pick_rounds": self._pick, "odo_corr": self._odo,
                  "select_fit": self._select}
        wraps = []
        for kernel, (mod_name, attr) in self.ENTRY_POINTS.items():
            try:
                mod = importlib.import_module(mod_name)
            except ImportError as e:
                self.missing[kernel] = f"{mod_name}: {e}"
                continue
            fn = getattr(mod, attr, None)
            if fn is None:
                self.missing[kernel] = f"{mod_name}.{attr} is not there"
                continue
            wraps.append((mod, attr, fn))
            setattr(mod, attr, makers[kernel](fn))
        try:
            yield self
        finally:
            for mod, attr, fn in wraps:
                setattr(mod, attr, fn)

    def _pick(self, fn):
        def wrapped(score_c, *a, **kw):
            R, W = score_c.shape
            self.add("pick_rounds", pick_work(
                R, W, kw["n_sharp"], kw["n_rest"], kw["rest_T"],
                kw["n_flat"], kw["S"]))
            return fn(score_c, *a, **kw)
        return wrapped

    def _odo(self, fn):
        def wrapped(q, planes, K, nearby):
            B = q.shape[0] if q.dim() == 3 else 1
            self.add("odo_corr", odo_work(q.shape[-2], planes.shape[-1], K,
                                          B))
            return fn(q, planes, K, nearby)
        return wrapped

    def _select(self, fn):
        def wrapped(specs):
            b = o = 0
            for sp in specs:
                nb, no = select_work(sp.N, sp.C, sp.gates["k"],
                                     sp.gates["mode"])
                b, o = b + nb, o + no
            self.add("select_fit", (b, o))
            return fn(specs)
        return wrapped


def share(run, kernel: str):
    """A kernel's roofline share (%) over the traced stretch, or None where
    the stretch has no device time of it. Raises where the kernel ran but
    its calls were not noted: its entry point could not be wrapped, or
    the program reached the kernel by another path."""
    if run.recorder is None or run.stretch is None:
        return None
    bounds = run.recorder.bounds[kernel]
    dev = run.stretch.device_s(KERNEL_NAMES[kernel])
    if kernel in run.recorder.missing and dev > 0:
        raise RuntimeError(
            f"{kernel} ran for {dev:.6f} s in the traced stretch, but its "
            f"calls were out of the yardstick's sight: "
            f"{run.recorder.missing[kernel]}")
    if dev <= 0:
        return None
    if not bounds:
        raise RuntimeError(
            f"{kernel} ran for {dev:.6f} s in the traced stretch, but no "
            f"call of it was noted at its entry point "
            f"{'.'.join(Recorder.ENTRY_POINTS[kernel])}")
    return 100.0 * sum(bounds) / dev
