"""Scan-context place recognition for loop-closure detection (port of the
JAX package's ``slam/scan_context.py``).

* descriptor: an (R rings x S sectors) polar grid around the sensor, each
  bin holding the max point height (one ``scatter_reduce`` "amax" into a
  trash-binned flat image);
* matching: column-shift-minimised cosine distance. Rotating the sensor
  permutes descriptor columns, so scoring all S cyclic shifts makes the
  match yaw-invariant, and the best shift is a yaw guess for the scan
  matcher. All shifts of all pairs are one batched matmul.

Parity with the JAX package: ranks and argmaxes keep the lower index on a
tie (stable sorts, first-max reductions); divisions by a constant divide
by a tensor (IEEE division on every device, as the JAX package's eager
operations divide), and the ring keys are rounded as ``jnp.mean`` rounds
them, so L1 key distances tie exactly where the JAX package's tie.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _div(x: Tensor, c: float) -> Tensor:
    """x / c by IEEE division (a Python-float divisor would become a
    reciprocal multiply on a CUDA tensor)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def compute_descriptor(xyz: Tensor, mask: Tensor, n_rings: int = 16,
                       n_sectors: int = 60, max_radius: float = 20.0,
                       min_z: float = -2.0) -> Tensor:
    """Scan-context descriptor of one scan: (n_rings, n_sectors) max-height
    image over a polar partition of the sensor's surroundings.

    xyz: (N, 3) sensor-frame points, mask: (N,) validity. Heights are
    offset by ``min_z`` so "empty bin" (0) sorts below any observed point.
    """
    x, y = xyz[:, 0], xyz[:, 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)                          # [-pi, pi]
    ring = torch.clamp((_div(r, max_radius) * n_rings).to(torch.int64),
                       0, n_rings - 1)
    sector = torch.clamp((_div(theta + math.pi, 2 * math.pi) * n_sectors)
                         .to(torch.int64), 0, n_sectors - 1)
    ok = mask & (r < max_radius)
    # invalid points route to a trash bin
    flat_bin = torch.where(ok, ring * n_sectors + sector,
                           n_rings * n_sectors)
    z = torch.where(ok, xyz[:, 2] - min_z,
                    torch.full((), -math.inf, device=xyz.device))
    img = torch.full((n_rings * n_sectors + 1,), -math.inf,
                     device=xyz.device).scatter_reduce(0, flat_bin, z, "amax")
    return torch.clamp(img[:-1], min=0.0).reshape(n_rings, n_sectors)


def _norm_cols(d: Tensor) -> Tensor:
    """Column-normalise (..., R, S) descriptors."""
    n = torch.linalg.vector_norm(d, dim=-2, keepdim=True)
    return d / torch.clamp(n, min=1e-6)


def _rolled(a: Tensor) -> Tensor:
    """(..., R, S) -> (..., S, R, S): shift k of the columns,
    ``rolled[..., k, :, j] = a[..., :, (j - k) mod S]`` (jnp.roll)."""
    S = a.shape[-1]
    ar = torch.arange(S, device=a.device)
    idx = (ar[None, :] - ar[:, None]) % S                # (k, j)
    return a[..., idx].movedim(-2, -3)


def _best_shift(sims: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """(1 - max score, first argmax shift) over ``dim``."""
    best, shift = torch.max(sims, dim=dim)
    return 1.0 - best, shift


def shifted_distances(desc_a: Tensor, descs_b: Tensor) -> Tuple[Tensor, Tensor]:
    """Distance of one descriptor (R, S) against a batch (M, R, S),
    minimised over all column shifts: (dist (M,), shift (M,)). Distance is
    1 - mean over sectors of the per-column cosine similarity at the best
    cyclic shift; the per-shift score of all shifts at once is an
    (S, RS) x (RS, M) matmul."""
    S = desc_a.shape[1]
    rolled = _rolled(_norm_cols(desc_a)).reshape(S, -1)
    b = _norm_cols(descs_b).reshape(descs_b.shape[0], -1)
    sims = _div(rolled @ b.T, S)                          # (S, M)
    return _best_shift(sims, 0)


def pairwise_min_distances(descs: Tensor) -> Tuple[Tensor, Tensor]:
    """All-pairs shift-minimised distances: (N, R, S) -> dist (N, N),
    best shift (N, N)."""
    N, _, S = descs.shape
    a = _norm_cols(descs)
    rolled = _rolled(a).reshape(N * S, -1)
    sims = _div(rolled @ a.reshape(N, -1).T, S).reshape(N, S, N)
    return _best_shift(sims, 1)


def ring_key(descs: Tensor) -> Tensor:
    """Rotation-invariant ring occupancy vector: (..., R, S) -> (..., R):
    the occupied count times the float32 reciprocal of S, as ``jnp.mean``
    computes it."""
    recip = float(np.float32(1.0) / np.float32(descs.shape[-1]))
    return (descs > 0).sum(-1).float() * recip


def _prescreened_distances(descs: Tensor, k: int, min_index_gap: int):
    """Two-stage pairwise distances: L1 ring-key ranking picks the k best
    admissible candidates per query (j - i >= min_index_gap; the lower
    index first on a tie, as ``lax.top_k``); only those pairs get exact
    shifted scoring. Non-candidates are +inf. Returns numpy (dist, shift).
    """
    n, _, S = descs.shape
    keys = ring_key(descs)                                   # (N, R)
    diff = torch.abs(keys[:, None, :] - keys[None, :, :])
    kd = diff[..., 0]
    for r in range(1, diff.shape[-1]):      # summed in ring order
        kd = kd + diff[..., r]
    ii = torch.arange(n, device=descs.device)
    inadmissible = (ii[None, :] - ii[:, None]) < min_index_gap
    kd = torch.where(inadmissible, torch.full((), math.inf,
                                              device=descs.device), kd)
    cand = torch.sort(kd, dim=1, stable=True).indices[:, :k]  # (N, k)
    a = _rolled(_norm_cols(descs)).reshape(n, S, -1)          # (N, S, RS)
    b = _norm_cols(descs[cand]).reshape(n, k, -1)             # (N, k, RS)
    d_sub, s_sub = _best_shift(_div(torch.bmm(a, b.transpose(1, 2)), S), 1)
    cand_np = cand.cpu().numpy()
    d = np.full((n, n), np.inf, np.float32)
    shift = np.zeros((n, n), np.int64)
    rows = np.arange(n)[:, None]
    d[rows, cand_np] = d_sub.cpu().numpy()
    shift[rows, cand_np] = s_sub.cpu().numpy()
    return d, shift


def detect_loops_scan_context(descs: np.ndarray, min_index_gap: int = 20,
                              max_dist: float = 0.25, max_loops: int = 8,
                              suppress_gap: int = 10, prescreen: int = 0,
                              device="cuda") -> List[Tuple[int, int, float]]:
    """Appearance-based loop candidates on ``device`` (the card unless the
    caller asks for the CPU).

    descs: (N, R, S) stacked keyframe descriptors. Returns (i, j,
    yaw_guess) triples, closest-first with non-max suppression; yaw_guess
    (radians) comes from the best column shift and seeds the scan matcher.
    ``prescreen > 0`` ranks pairs by ring keys first and scores only the
    best ``prescreen`` per query.
    """
    descs = torch.as_tensor(np.asarray(descs), dtype=torch.float32,
                            device=device)
    n, _, n_sectors = descs.shape
    if n < 2:
        return []
    if prescreen and n > prescreen:
        d, shift = _prescreened_distances(descs, prescreen, min_index_gap)
    else:
        d, shift = (x.cpu().numpy() for x in pairwise_min_distances(descs))
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    cand = (jj - ii >= min_index_gap) & (d < max_dist)
    order = np.argsort(d[cand])
    ci, cj = ii[cand][order], jj[cand][order]
    picked: List[Tuple[int, int, float]] = []
    for i, j in zip(ci, cj):
        if len(picked) >= max_loops:
            break
        if any(abs(i - pi) < suppress_gap and abs(j - pj) < suppress_gap
               for pi, pj, _ in picked):
            continue
        # best shift k: rolling i's columns by k matches j, i.e. frame j is
        # rotated by -k sectors relative to frame i
        yaw = -float(shift[i, j]) / n_sectors * 2.0 * np.pi
        if yaw <= -np.pi:
            yaw += 2.0 * np.pi
        picked.append((int(i), int(j), yaw))
    return picked
