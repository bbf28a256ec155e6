"""Block-Thomas solve of a symmetric block-tridiagonal system:
``csrc/block_tridiag.cu`` on a CUDA tensor, the plain PyTorch version below
on a CPU tensor.

Replaces the XLA ``lax.scan`` sweeps of the JAX package's
``slam/posegraph.py`` (``solve_block_tridiag`` /
``solve_block_tridiag_multi``); no Pallas kernel is involved. For D
(N, 6, 6), U (N-1, 6, 6) and B (N, 6, m) it returns X with
tridiag(Uᵀ, D, U) X = B. Each 6x6 solve is Gaussian elimination with
partial pivoting (first maximal |pivot|, divisions, never reciprocals) and
each 6-term block product is summed k = 0..5 as separate multiplies and
adds, in the same order in both versions: the kernel is bit-equal to the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from msf_loam_tpu_torch import kernels

Tensor = torch.Tensor

_FAC = 72          # floats of one step's factor in the kernel's scratch
MAX_RHS = 1024     # right-hand-side columns one launch takes
_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]


def _factor(A: Tensor):
    """Gaussian elimination with partial pivoting of a 6x6, rows swapped as
    it goes. Returns (eliminated rows, multipliers, pivot order): row i of
    the first two is the row that ended at position i; ``F[i, k]`` is its
    multiplier at step k (for i > k). No host synchronisation."""
    G = torch.cat([A, torch.zeros_like(A)], dim=1)   # [A | F]
    rows = torch.arange(6, device=A.device)
    perm = rows.clone()
    for k in range(6):
        p = torch.argmax(G[k:, k].abs()) + k          # first maximal |pivot|
        idx = rows.clone()
        idx[k] = p
        idx.index_put_((p,), rows[k])
        G = G.index_select(0, idx)
        perm = perm.index_select(0, idx)
        if k < 5:
            f = G[k + 1:, k] / G[k, k]
            G[k + 1:, 6 + k] = f
            G[k + 1:, k + 1:6] -= f[:, None] * G[k, k + 1:6]
    return G[:, :6], G[:, 6:], perm


def _apply(fac, R: Tensor) -> Tensor:
    """Solve with a stored factor for the columns of R (6, c)."""
    A, F, perm = fac
    Y = R.index_select(0, perm)
    for k in range(5):
        Y[k + 1:] -= F[k + 1:, k:k + 1] * Y[k:k + 1]
    for k in range(5, -1, -1):
        Y[k] /= A[k, k]
        if k:
            Y[:k] -= A[:k, k:k + 1] * Y[k:k + 1]
    return Y


def _product(L: Tensor, C: Tensor) -> Tensor:
    """L (6, 6) @ C (6, c), summed k = 0..5 as separate multiplies and
    adds."""
    acc = L[:, 0:1] * C[0:1]
    for k in range(1, 6):
        acc = acc + L[:, k:k + 1] * C[k:k + 1]
    return acc


def block_tridiag_plain(D: Tensor, U: Tensor, B: Tensor) -> Tensor:
    """Plain PyTorch version: the kernel's recurrence, one block step at a
    time from Python."""
    N = D.shape[0]
    facs = []
    bts = [B[0]]
    dt = D[0]
    for i in range(1, N):
        fac = _factor(dt)
        facs.append(fac)
        Y = _apply(fac, U[i - 1])
        step = torch.cat([D[i], B[i]], dim=1) - \
            _product(Y.T, torch.cat([U[i - 1], bts[-1]], dim=1))
        dt = step[:, :6]
        bts.append(step[:, 6:])
    facs.append(_factor(dt))
    X = [None] * N
    X[N - 1] = _apply(facs[N - 1], bts[N - 1])
    for i in range(N - 2, -1, -1):
        X[i] = _apply(facs[i], bts[i] - _product(U[i], X[i + 1]))
    return torch.stack(X)


def block_tridiag(D: Tensor, U: Tensor, B: Tensor) -> Tensor:
    """X (N, 6, m) with tridiag(Uᵀ, D, U) X = B, for float32 D (N, 6, 6),
    U (N-1, 6, 6), B (N, 6, m): one kernel launch on a CUDA tensor, the
    plain version on a CPU tensor."""
    N, m = B.shape[0], B.shape[-1]
    if D.shape != (N, 6, 6) or U.shape != (max(N - 1, 0), 6, 6) or \
            B.dim() != 3 or B.shape[1] != 6 or N < 1 or m < 1:
        raise ValueError(f"block_tridiag: D (N,6,6), U (N-1,6,6), B (N,6,m) "
                         f"expected, got {tuple(D.shape)}, {tuple(U.shape)}, "
                         f"{tuple(B.shape)}")
    if B.device.type == "cpu":
        return block_tridiag_plain(D, U, B)
    if any(t.dtype != torch.float32 or t.device != B.device
           for t in (D, U, B)) or m > MAX_RHS:
        raise ValueError("block_tridiag: D, U, B must be float32 on one "
                         f"device, with at most {MAX_RHS} columns")
    D, U, B = D.contiguous(), U.contiguous(), B.contiguous()
    X = torch.empty_like(B)
    work = torch.empty(N * (_FAC + 6 * m), dtype=torch.float32,
                       device=B.device)
    piv = torch.empty(N * 6, dtype=torch.int32, device=B.device)
    fn = kernels.function("block_tridiag", "block_tridiag_launch",
                          _LAUNCH_ARGS)
    err = fn(D.data_ptr(), U.data_ptr(), B.data_ptr(), X.data_ptr(),
             work.data_ptr(), piv.data_ptr(), N, m, kernels.stream(B.device))
    kernels.check(err, "block_tridiag")
    kernels.LAUNCHES["block_tridiag"] += 1
    return X


def launch_geometry(m: int) -> dict:
    """Threads, dynamic shared memory bytes, registers and local bytes per
    thread of the (one-block) launch for m right-hand sides."""
    out = [ctypes.c_int() for _ in range(4)]
    fn = kernels.function("block_tridiag", "block_tridiag_geometry",
                          [ctypes.c_int] + [ctypes.c_void_p] * 4)
    kernels.check(fn(m, *(ctypes.addressof(o) for o in out)),
                  "block_tridiag geometry")
    return dict(blocks=1, **dict(zip(("threads", "smem", "regs", "local"),
                                     (o.value for o in out))))
