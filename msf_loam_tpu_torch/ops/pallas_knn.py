"""Brute-force k nearest neighbours: ``csrc/knn.cu`` on a CUDA tensor, the
plain PyTorch version below on a CPU tensor.

Replaces the Pallas kernel ``msf_loam_tpu/ops/pallas_knn.py``
(``knn_pallas``; ``knn_auto`` is its entry point). (Q, 3) queries against
(M, 3) reference points with a validity mask -> (d2, idx) (Q, k), ascending
in d2, ties to the lowest ref index. Distances are exact float32
``min(((pen + dx^2) + dy^2) + dz^2, 3e38)`` with pen 0 for a valid ref and
3e38 for a masked one (never ``|q|^2 + |r|^2 - 2 q.r``). A masked ref never
enters the result; a slot that no valid ref fills is (3e38, -1).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from msf_loam_tpu_torch import kernels

Tensor = torch.Tensor

_INF = 3.0e38
MAX_K = 16           # the kernel keeps its top-k in registers
_CHUNK = 1024        # refs staged in shared memory per step (csrc/knn.cu)
_THREADS = 128       # queries per block (csrc/knn.cu)
_TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs


def _distances(query: Tensor, ref: Tensor, pen: Tensor) -> Tensor:
    d2 = pen[None, :]
    for ax in range(3):
        diff = query[:, ax:ax + 1] - ref[None, :, ax]
        d2 = d2 + diff * diff
    return torch.clamp(d2, max=_INF)


def knn_plain(query: Tensor, ref: Tensor, ref_mask: Tensor, k: int,
              chunk: int = 2048) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version: chunks of the distance matrix merged into the
    running best by a stable sort of [best | chunk], so among equal d2 the
    lowest ref index wins."""
    Q, M = query.shape[0], ref.shape[0]
    dev = query.device
    pen = torch.where(ref_mask, torch.zeros((), device=dev),
                      torch.full((), _INF, device=dev))
    best_d = torch.full((Q, k), _INF, device=dev)
    best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for lo in range(0, M, chunk):
        hi = min(M, lo + chunk)
        d = _distances(query, ref[lo:hi], pen[lo:hi])
        idx = torch.arange(lo, hi, device=dev).expand(Q, hi - lo)
        cat_d = torch.cat([best_d, d], dim=1)
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(torch.cat([best_i, idx], dim=1), 1, order)
    empty = best_d >= _INF * 0.5
    return (torch.where(empty, torch.full_like(best_d, _INF), best_d),
            torch.where(empty, -1, best_i).to(torch.int32))


def split_ranges(Q: int, M: int) -> Tuple[int, int]:
    """(S, range_len): the ref axis is cut into S contiguous ranges of
    range_len refs (a multiple of the shared-memory chunk) so that about
    _TARGET_BLOCKS blocks run."""
    q_blocks = -(-Q // _THREADS)
    chunks = max(1, -(-M // _CHUNK))
    S = max(1, min(chunks, -(-_TARGET_BLOCKS // q_blocks)))
    per = -(-chunks // S)
    return -(-chunks // per), per * _CHUNK


def knn_pallas(query: Tensor, ref: Tensor, ref_mask: Tensor,
               k: int = 8) -> Tuple[Tensor, Tensor]:
    """k-NN of (Q, 3) queries among (M, 3) masked refs: (d2 (Q, k) float32,
    idx (Q, k) int32). The kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn: k={k} must be in [1, {MAX_K}]")
    if query.device.type == "cpu":
        return knn_plain(query.float(), ref.float(), ref_mask.bool(), k)
    Q, M = query.shape[0], ref.shape[0]
    if query.dtype != torch.float32 or query.shape != (Q, 3) or \
            not query.is_contiguous() or ref.dtype != torch.float32 or \
            ref.shape != (M, 3) or not ref.is_contiguous() or \
            ref_mask.dtype != torch.bool or ref_mask.shape != (M,) or \
            not ref_mask.is_contiguous() or ref.device != query.device or \
            ref_mask.device != query.device:
        raise ValueError("knn: query (Q, 3) and ref (M, 3) must be contiguous "
                         "float32 and ref_mask a contiguous (M,) bool tensor, "
                         "all on one device")
    dev = query.device
    S, range_len = split_ranges(Q, M)
    part_d = torch.empty((Q, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, S, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    fn = kernels.library("knn").knn_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    err = fn(query.data_ptr(), ref.data_ptr(), ref_mask.data_ptr(), Q, M, k,
             S, range_len, part_d.data_ptr(), part_i.data_ptr(),
             out_d.data_ptr(), out_i.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(err, "knn")
    kernels.LAUNCHES["knn"] += 1
    return out_d, out_i


def knn_auto(query: Tensor, ref: Tensor, ref_mask: Tensor,
             k: int = 8) -> Tuple[Tensor, Tensor]:
    """The entry point: ``knn_pallas`` on the tensors' device."""
    return knn_pallas(query, ref, ref_mask, k=k)
