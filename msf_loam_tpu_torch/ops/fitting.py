"""Batched closed-form geometric fits (port of the JAX package's
``ops/fitting.py``): the trigonometric 3x3 symmetric eigensolver, the line
fit with its eigenvalue-ratio test, the total-least-squares plane fit with
its spread gate, the two-scale plane fit with the wide-set fallback, and
the adjugate 3x3 solve.

They serve the scan-to-map association that queries the map every round
(``mapping.reuse_candidates=False`` and the sharded map's hooks). The JAX
package computes them as XLA outside any Pallas kernel, so the port runs
them as plain PyTorch. Division by the constants 3 and 6 is a multiply by
the float32 reciprocal (``div_scale``), as XLA compiles it under ``jit``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from msf_loam_tpu_torch.core.se3 import cross
from msf_loam_tpu_torch.ops.voxel import div_scale

Tensor = torch.Tensor


def _moments(pts: Tensor, m: Tensor) -> Tensor:
    """Σ_k d_ki d_kj over the K axis: (..., K, 3) -> (..., 3, 3)."""
    return torch.einsum("...ki,...kj->...ij", pts * m, pts * m)


def eigh3x3(A: Tensor) -> Tuple[Tensor, Tensor]:
    """Eigenvalues (descending) and eigenvectors of symmetric 3x3 matrices
    by the trigonometric method, batched over leading axes: (w (..., 3),
    V (..., 3, 3)) with V[..., :, i] the eigenvector of w[..., i]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = div_scale(a00 + a11 + a22, 3.0)
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(div_scale(p2, 6.0), min=1e-30))

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = (A - q[..., None, None] * eye) / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = div_scale(torch.arccos(r), 3.0)

    w0 = q + 2.0 * p * torch.cos(phi)
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2

    # near-diagonal matrices: the eigenvalues are the sorted diagonal
    diag_sorted = -torch.sort(-torch.stack([a00, a11, a22], -1), -1).values
    w = torch.where((p1 < 1e-12)[..., None], diag_sorted,
                    torch.stack([w0, w1, w2], -1))

    def eigvec(wj: Tensor, wk: Tensor) -> Tensor:
        """Dominant column of (A - wj I)(A - wk I), e_x where it vanishes
        (a repeated eigenvalue, rejected downstream by the gates)."""
        M = (A - wj[..., None, None] * eye) @ (A - wk[..., None, None] * eye)
        col = torch.argmax((M * M).sum(-2), dim=-1)
        v = torch.gather(M, -1, col[..., None, None].expand(
            M.shape[:-1] + (1,)))[..., 0]
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return torch.where(n > 1e-20, v / torch.clamp(n, min=1e-30),
                           eye[0].expand_as(v))

    # the two extreme eigenvectors directly, the middle one by cross
    # product (the JAX module explains why not the other way round)
    v0 = eigvec(w[..., 1], w[..., 2])
    v2 = eigvec(w[..., 0], w[..., 1])
    v1 = cross(v2, v0)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True),
                          min=1e-30)
    return w, torch.stack([v0, v1, v2], -1)


class LineFit(NamedTuple):
    center: Tensor     # (..., 3) centroid of the neighbours
    direction: Tensor  # (..., 3) unit direction (largest eigenvector)
    valid: Tensor      # (...,) bool: passed the eigenvalue-ratio test


class PlaneFit(NamedTuple):
    center: Tensor     # (..., 3)
    normal: Tensor     # (..., 3) unit
    valid: Tensor      # (...,) bool


def _centroid(pts: Tensor, m: Tensor) -> Tensor:
    return (pts * m).sum(-2) / torch.clamp(m.sum(-2), min=1.0)


def fit_lines(neighbors: Tensor, neighbor_valid: Tensor,
              eig_ratio: float = 3.0) -> LineFit:
    """A 3D line through each K-neighbourhood (..., K, 3): the centroid,
    the largest eigenvector of the scatter, valid where every neighbour is
    valid and lambda_max > eig_ratio * lambda_mid."""
    m = neighbor_valid[..., None].to(neighbors.dtype)
    center = _centroid(neighbors, m)
    d = neighbors - center[..., None, :]
    w, V = eigh3x3(_moments(d, m))
    valid = neighbor_valid.all(-1) & (w[..., 0] > eig_ratio * w[..., 1])
    return LineFit(center, V[..., :, 0], valid)


def _resid(normal: Tensor, pts: Tensor, center: Tensor,
           valid: Tensor) -> Tensor:
    """|n . (p - c)| per neighbour, 0 where the neighbour is invalid."""
    r = torch.einsum("...i,...ki->...k", normal, pts - center[..., None, :])
    return torch.where(valid, r.abs(), torch.zeros_like(r))


def fit_planes(neighbors: Tensor, neighbor_valid: Tensor,
               tol: float = 0.2, cond_frac: float = 0.05) -> PlaneFit:
    """Total-least-squares plane per K-neighbourhood on centred
    coordinates: valid where every neighbour is valid and within ``tol``
    of the plane, and the scatter spans 2D (lambda_mid > cond_frac *
    lambda_max)."""
    m = neighbor_valid[..., None].to(neighbors.dtype)
    center = _centroid(neighbors, m)
    w, V = eigh3x3(_moments(neighbors - center[..., None, :], m))
    normal = V[..., :, 2]
    resid = _resid(normal, neighbors, center, neighbor_valid)
    valid = (neighbor_valid.all(-1) & (resid <= tol).all(-1)
             & (w[..., 1] > cond_frac * w[..., 0]))
    return PlaneFit(center, normal, valid)


def fit_planes_two_scale(near: Tensor, near_valid: Tensor, wide: Tensor,
                         wide_valid: Tensor, tol: float = 0.2,
                         cond_frac: float = 0.05,
                         min_wide: int = 5) -> PlaneFit:
    """The strict plane fit, with a TLS fit on the wide set where the
    strict one fails: accepted when the wide set has at least
    ``min_wide`` points, passes the same gates, and every valid near
    neighbour lies within ``tol`` of it."""
    near_fit = fit_planes(near, near_valid, tol, cond_frac)
    m = wide_valid[..., None].to(wide.dtype)
    cnt = m.sum(-2)
    center = (wide * m).sum(-2) / torch.clamp(cnt, min=1.0)
    w, V = eigh3x3(_moments(wide - center[..., None, :], m))
    normal = V[..., :, 2]
    fb_ok = ((cnt[..., 0] >= min_wide)
             & (w[..., 1] > cond_frac * w[..., 0])
             & (_resid(normal, wide, center, wide_valid) <= tol).all(-1)
             & (_resid(normal, near, center, near_valid) <= tol).all(-1))
    use_fb = ~near_fit.valid & fb_ok
    return PlaneFit(
        center=torch.where(use_fb[..., None], center, near_fit.center),
        normal=torch.where(use_fb[..., None], normal, near_fit.normal),
        valid=near_fit.valid | use_fb)


def _solve3x3(A: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched 3x3 solve by the adjugate: (x, det); x is 0 where
    |det| <= 1e-30."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = torch.where(det.abs() > 1e-30, 1.0 / det,
                          torch.zeros_like(det))
    adj = torch.stack([
        c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11,
        c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12,
        c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], -1
    ).reshape(A.shape)
    x = torch.einsum("...ij,...j->...i", adj, b) * inv_det[..., None]
    return x, det
