"""Distributed block-tridiagonal solves for the pose graph (port of the
JAX package's ``parallel/distributed_ba.py``).

The N pose blocks split over the mesh ``data`` axis in contiguous chunks
of N/D. Every rank holds the whole system (the assembly runs replicated,
as in JAX) and solves only its chunk's share:

1. condense its chunk onto the chunk's separator chain, segment by
   segment (``block_tridiag_condense``: one kernel launch, the condensation
   of the one-launch solve);
2. all-gather the chains of every rank and join them (a rank's last
   separator couples to the next rank's first through the system's U at
   the chunk boundary); every rank solves the joined chain of 2PD blocks
   (``block_tridiag``: one launch) and keeps its own 2P blocks;
3. back-substitute its chunk's interiors (``block_tridiag_backsub``: one
   launch);
4. all-gather the chunks' solutions, so that the solution is whole on
   every rank for the replicated retraction.

The Woodbury solve of the loop-closure graph runs [b | W] through 1-3,
sums its capacitance terms (S = I + Σ Wᵀ Z, Wᵀ y) with one all-reduce of
a packed buffer, corrects its chunk and gathers (4). The answers are
exact, as the one-launch solve's.
"""

from __future__ import annotations

import torch

from msf_loam_tpu_torch.ops.block_tridiag import (block_tridiag,
                                                  block_tridiag_backsub,
                                                  block_tridiag_condense)
from msf_loam_tpu_torch.parallel.mesh import Axis, Mesh

Tensor = torch.Tensor


def _chunk(ax: Axis, N: int):
    n = N // ax.size
    if N % ax.size or n < 2:
        raise ValueError(f"{N} blocks do not split over a {ax.size}-way "
                         f"data axis into chunks of at least 2 "
                         f"(pad_graph / next_bucket size the graph)")
    return ax.index * n, n


def _solve_chunk(ax: Axis, D: Tensor, U: Tensor, B: Tensor) -> Tensor:
    """Steps 1-3: this rank's rows of tridiag(Uᵀ, D, U)⁻¹ B."""
    N, m = B.shape[0], B.shape[2]
    lo, n = _chunk(ax, N)
    cond = block_tridiag_condense(D[lo:lo + n], U[lo:lo + n - 1],
                                  B[lo:lo + n])
    P2 = 2 * cond.P
    buf = torch.cat([cond.Dg.reshape(-1), cond.Ug.reshape(-1),
                     cond.Bg.reshape(-1)])
    allb = ax.all_gather(buf)                                 # (R, ·)
    R = allb.shape[0]
    nd, nu = P2 * 36, (P2 - 1) * 36
    Dg = allb[:, :nd].reshape(R * P2, 6, 6)
    Ug_in = allb[:, nd:nd + nu].reshape(R, P2 - 1, 6, 6)
    Bg = allb[:, nd + nu:].reshape(R * P2, 6, m)
    # a rank's last separator couples to the next rank's first through the
    # system's U at their chunk boundary
    bound = U[n - 1::n][:R - 1]                               # (R-1, 6, 6)
    Ug = torch.cat([Ug_in, torch.cat([bound, bound.new_zeros((1, 6, 6))]
                                     )[:, None]], 1).reshape(-1, 6, 6)[:-1]
    xg = block_tridiag(Dg, Ug, Bg)
    r = ax.index
    return block_tridiag_backsub(cond, xg[r * P2:(r + 1) * P2])


def _gather_rows(ax: Axis, x: Tensor) -> Tensor:
    """Step 4: every rank's chunk, whole on every rank."""
    g = ax.all_gather(x)
    return g.reshape((-1,) + tuple(x.shape[1:]))


def distributed_tridiag_solve(mesh: Mesh, D: Tensor, U: Tensor,
                              b: Tensor) -> Tensor:
    """x (N, 6) with tridiag(Uᵀ, D, U) x = b, the chunks over the ``data``
    axis (N divisible by it, chunks of at least 2 blocks)."""
    ax = mesh.axis("data")
    return _gather_rows(ax, _solve_chunk(ax, D, U, b[..., None]))[..., 0]


def distributed_tridiag_solve_multi(mesh: Mesh, D: Tensor, U: Tensor,
                                    B: Tensor) -> Tensor:
    """X (N, 6, m) for m right-hand sides B (N, 6, m)."""
    ax = mesh.axis("data")
    return _gather_rows(ax, _solve_chunk(ax, D, U, B))


def distributed_woodbury_solve(mesh: Mesh, D: Tensor, U: Tensor, b: Tensor,
                               W: Tensor) -> Tensor:
    """x with (tridiag(Uᵀ, D, U) + W Wᵀ) x = b; W (N, 6, m) stacks the
    weighted loop Jacobian columns (``slam.posegraph``)."""
    ax = mesh.axis("data")
    m = W.shape[-1]
    lo, n = _chunk(ax, b.shape[0])
    X = _solve_chunk(ax, D, U, torch.cat([b[..., None], W], -1))
    y, Z = X[..., 0], X[..., 1:]
    Wl = W[lo:lo + n]
    buf = ax.all_reduce(torch.cat([
        torch.einsum("nim,nik->mk", Wl, Z).reshape(-1),
        torch.einsum("nim,ni->m", Wl, y)]))
    S = torch.eye(m, device=W.device) + buf[:m * m].view(m, m)
    c = torch.linalg.solve_ex(S, buf[m * m:])[0]
    return _gather_rows(ax, y - torch.einsum("nim,m->ni", Z, c))
