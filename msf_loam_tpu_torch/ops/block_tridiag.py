"""Segmented solve of a symmetric block-tridiagonal system:
``csrc/block_tridiag.cu`` on a CUDA tensor, the plain PyTorch version below
on a CPU tensor.

Replaces the XLA ``lax.scan`` sweeps of the JAX package's
``slam/posegraph.py`` (``solve_block_tridiag`` /
``solve_block_tridiag_multi``); no Pallas kernel is involved. For D
(N, 6, 6), U (N-1, 6, 6) and B (N, 6, m) it returns X with
tridiag(Uᵀ, D, U) X = B, by the decomposition of the JAX package's
``parallel/distributed_ba.py`` with segments in place of devices: the
blocks are cut into P segments of L (``segments``); each segment condenses
its interior onto its first and last block (Schur complement, the
recurrence of ``_condense_chain``); the 2P endpoint blocks are solved by
block-Thomas; each segment back-substitutes its interior. The segments run
in parallel, so the chain of dependent 6x6 steps is about 2L + 4P instead
of 2N.

Each 6x6 solve is Gaussian elimination with partial pivoting (first
maximal |pivot|, divisions, never reciprocals) and each 6-term product is
summed k = 0..5 as separate multiplies and adds, in the same order in both
versions: the kernel is bit-equal to the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from msf_loam_tpu_torch import kernels

Tensor = torch.Tensor

MAX_RHS = 1024     # right-hand-side columns one launch takes
_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SCRATCH_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def segments(N: int, seg_len: Optional[int] = None) -> Tuple[int, int]:
    """(L, P): P segments of L blocks, the last holding the rest. The rule
    L = max(2, isqrt(2N)) about minimises the chain depth 2L + 4P
    (L = 128, P = 64 at N = 8192); ``seg_len`` forces L. A last segment of
    one block joins the one before it, so every segment holds at least 2
    blocks unless N = 1."""
    if N == 1:
        return 1, 1
    L = max(2, math.isqrt(2 * N)) if seg_len is None else int(seg_len)
    if L < 2:
        raise ValueError(f"block_tridiag: segments of at least 2 blocks, "
                         f"got seg_len={seg_len}")
    P = -(-N // L)
    if P > 1 and N - (P - 1) * L == 1:
        P -= 1
    return L, P


def chain_depth(N: int, L: int, P: int) -> int:
    """Dependent 6x6 steps of one solve: condensation and back-substitution
    of the longest segment, and the separator's forward and backward
    sweeps."""
    longest = N if P == 1 else max(L, N - (P - 1) * L)
    nsep = 1 if N == 1 else 2 * P
    return 2 * max(longest - 2, 0) + 2 * nsep - 1


# ------------------------------------------------------------ plain version
# Every helper works on a leading batch axis (the segments).
def _swap_rows(G: Tensor, k: int, p: Tensor) -> Tensor:
    """Rows k and p[b] of each G[b] swapped."""
    n = G.shape[0]
    idx = torch.arange(G.shape[1], device=G.device).repeat(n, 1)
    idx[:, k] = p
    idx[torch.arange(n, device=G.device), p] = k
    return torch.gather(G, 1, idx[:, :, None].expand_as(G))


def _back(G: Tensor, Y: Tensor) -> Tensor:
    """Back substitution with the upper factor held in G[:, :, :6]."""
    for k in range(5, -1, -1):
        Y[:, k] = Y[:, k] / G[:, k, k:k + 1]
        if k:
            Y[:, :k] = Y[:, :k] - G[:, :k, k:k + 1] * Y[:, k:k + 1]
    return Y


def _eliminate(A: Tensor, R: Tensor):
    """Gaussian elimination with partial pivoting of A (n, 6, 6), carried
    over the columns of R (n, 6, c). Returns the factor (lu, piv) and
    A⁻¹R: step k swaps rows k and piv[:, k] and keeps its multipliers at
    lu[:, i, k], i > k, in that step's row order; lu's upper triangle is the
    upper factor. No host synchronisation."""
    G = torch.cat([A, R], dim=2)
    lu = torch.zeros_like(A)
    piv = []
    for k in range(6):
        p = torch.argmax(G[:, k:, k].abs(), dim=1) + k   # first maximal
        piv.append(p)
        G = _swap_rows(G, k, p)
        if k < 5:
            f = G[:, k + 1:, k] / G[:, k:k + 1, k]
            lu[:, k + 1:, k] = f
            G[:, k + 1:, k + 1:] = G[:, k + 1:, k + 1:] - \
                f[:, :, None] * G[:, k:k + 1, k + 1:]
    lower = torch.ones(6, 6, dtype=torch.bool, device=A.device).tril(-1)
    lu = torch.where(lower, lu, G[:, :, :6])
    return (lu, torch.stack(piv, 1)), _back(G, G[:, :, 6:].clone())


def _apply(fac, R: Tensor) -> Tensor:
    """A⁻¹R with a stored factor of A, for R (n, 6, c)."""
    lu, piv = fac
    Y = R.clone()
    for k in range(6):
        Y = _swap_rows(Y, k, piv[:, k])
        if k < 5:
            Y[:, k + 1:] = Y[:, k + 1:] - lu[:, k + 1:, k:k + 1] * Y[:, k:k + 1]
    return _back(lu, Y)


def _mm(A: Tensor, Z: Tensor) -> Tensor:
    """A Z for A (n, 6, 6), Z (n, 6, c), summed k = 0..5 as separate
    multiplies and adds."""
    acc = A[:, :, 0:1] * Z[:, 0:1]
    for k in range(1, 6):
        acc = acc + A[:, :, k:k + 1] * Z[:, k:k + 1]
    return acc


def _mm_t(A: Tensor, Z: Tensor) -> Tensor:
    """Aᵀ Z, summed as ``_mm``."""
    return _mm(A.transpose(1, 2), Z)


def _thomas(Dg: Tensor, Ug: Tensor, Bg: Tensor) -> Tensor:
    """Block-Thomas over the separator blocks (n, 6, 6), (n-1, 6, 6),
    (n, 6, m): the kernel's phase 2, one block step at a time."""
    n = Dg.shape[0]
    facs, bts = [], [Bg[0:1]]
    dt = Dg[0:1]
    for i in range(1, n):
        fac, Y = _eliminate(dt, Ug[i - 1:i])
        facs.append(fac)
        step = torch.cat([Dg[i:i + 1], Bg[i:i + 1]], 2) - \
            _mm_t(Y, torch.cat([Ug[i - 1:i], bts[-1]], 2))
        dt = step[:, :, :6]
        bts.append(step[:, :, 6:])
    facs.append(_eliminate(dt, bts[-1][:, :, :0])[0])
    X = [None] * n
    X[n - 1] = _apply(facs[n - 1], bts[n - 1])
    for i in range(n - 2, -1, -1):
        X[i] = _apply(facs[i], bts[i] - _mm(Ug[i:i + 1], X[i + 1]))
    return torch.cat(X)


class Condensed(NamedTuple):
    """One solve's condensation: the separator chain (diagonal blocks
    Dg (2P, 6, 6), couplings Ug (2P-1, 6, 6) alternating between each
    segment's condensed S0e and the U between segments, right-hand sides
    Bg (2P, 6, m)) and what back-substitution needs (``res``: the plain
    version's per-step residues, or the kernel's scratch)."""
    Dg: Tensor
    Ug: Tensor
    Bg: Tensor
    U: Tensor
    N: int
    L: int
    P: int
    res: tuple


def _condense_plain(D: Tensor, U: Tensor, B: Tensor, L: int, P: int):
    """Phase 1 of the plain version: every segment condensed at once (a
    segment whose interior is done keeps its state through
    ``torch.where``). Returns the separator chain and the residues."""
    N, m = B.shape[0], B.shape[2]
    dev = B.device
    start = torch.arange(P, device=dev) * L
    lens = torch.full((P,), L, device=dev)
    lens[-1] = N - (P - 1) * L
    steps = int(lens.max()) - 2
    S00, S0k, Skk = D[start], U[start], D[start + 1]
    b0, bk = B[start], B[start + 1]
    res = []
    for k in range(1, steps + 1):
        live = (k <= lens - 2)[:, None, None]
        g = (start + k).clamp(max=N - 2)
        Uk, Dn, Bn = U[g], D[g + 1], B[g + 1]
        fac, Z = _eliminate(Skk, torch.cat([S0k.transpose(1, 2), Uk, bk], 2))
        res.append((fac, S0k, bk))
        top = _mm(S0k, Z)
        bot = _mm_t(Uk, Z[:, :, 6:])
        S00 = torch.where(live, S00 - top[:, :, :6], S00)
        b0 = torch.where(live, b0 - top[:, :, 12:], b0)
        S0k = torch.where(live, -top[:, :, 6:12], S0k)
        Skk = torch.where(live, Dn - bot[:, :, :6], Skk)
        bk = torch.where(live, Bn - bot[:, :, 6:], bk)
    ends = start + lens - 1
    Ub = U[ends.clamp(max=N - 2)]
    Dg = torch.stack([S00, Skk], 1).reshape(2 * P, 6, 6)
    Ug = torch.stack([S0k, Ub], 1).reshape(2 * P, 6, 6)[:-1]
    Bg = torch.stack([b0, bk], 1).reshape(2 * P, 6, m)
    return Dg, Ug, Bg, (start, lens, steps, res)


def _backsub_plain(U: Tensor, N: int, res: tuple, xg: Tensor) -> Tensor:
    """Phase 3 of the plain version: every segment's interior from its
    solved first and last block ``xg`` (2P, 6, m)."""
    start, lens, steps, res = res
    P, m = start.shape[0], xg.shape[2]
    ends = start + lens - 1
    xg = xg.reshape(P, 2, 6, m)
    X = xg.new_empty((N, 6, m))
    X[start], X[ends] = xg[:, 0], xg[:, 1]
    x0, xn = xg[:, 0], xg[:, 1]
    for k in range(steps, 0, -1):
        live = k <= lens - 2
        fac, S0k_k, bk_k = res[k - 1]
        Uk = U[(start + k).clamp(max=N - 2)]
        x = _apply(fac, bk_k - _mm_t(S0k_k, x0) - _mm(Uk, xn))
        xn = torch.where(live[:, None, None], x, xn)
        X[(start + k)[live]] = x[live]
    return X


def block_tridiag_plain(D: Tensor, U: Tensor, B: Tensor,
                        seg_len: Optional[int] = None) -> Tensor:
    """Plain PyTorch version: the kernel's decomposition, each condensation
    and back-substitution step on all segments at once, the separator one
    block step at a time."""
    N = B.shape[0]
    L, P = segments(N, seg_len)
    if N == 1:
        return _thomas(D, U, B)
    Dg, Ug, Bg, res = _condense_plain(D, U, B, L, P)
    return _backsub_plain(U, N, res, _thomas(Dg, Ug, Bg))


# ------------------------------------------------------------ the kernel
def block_tridiag(D: Tensor, U: Tensor, B: Tensor,
                  seg_len: Optional[int] = None) -> Tensor:
    """X (N, 6, m) with tridiag(Uᵀ, D, U) X = B, for float32 D (N, 6, 6),
    U (N-1, 6, 6), B (N, 6, m): one cooperative kernel launch on a CUDA
    tensor, the plain version on a CPU tensor. ``seg_len`` forces the
    segment length (tests and chip checks; the main path leaves it None)."""
    N, m = B.shape[0], B.shape[-1]
    if D.shape != (N, 6, 6) or U.shape != (max(N - 1, 0), 6, 6) or \
            B.dim() != 3 or B.shape[1] != 6 or N < 1 or m < 1:
        raise ValueError(f"block_tridiag: D (N,6,6), U (N-1,6,6), B (N,6,m) "
                         f"expected, got {tuple(D.shape)}, {tuple(U.shape)}, "
                         f"{tuple(B.shape)}")
    L, P = segments(N, seg_len)
    if B.device.type == "cpu":
        return block_tridiag_plain(D, U, B, seg_len)
    if any(t.dtype != torch.float32 or t.device != B.device
           for t in (D, U, B)) or m > MAX_RHS:
        raise ValueError("block_tridiag: D, U, B must be float32 on one "
                         f"device, with at most {MAX_RHS} columns")
    D, U, B = D.contiguous(), U.contiguous(), B.contiguous()
    nf, ni = ctypes.c_longlong(), ctypes.c_longlong()
    kernels.check(kernels.function(
        "block_tridiag", "block_tridiag_scratch", _SCRATCH_ARGS)(
        N, m, L, P, ctypes.addressof(nf), ctypes.addressof(ni)),
        "block_tridiag scratch")
    X = torch.empty_like(B)
    work = torch.empty(nf.value, dtype=torch.float32, device=B.device)
    piv = torch.empty(ni.value, dtype=torch.int32, device=B.device)
    fn = kernels.function("block_tridiag", "block_tridiag_launch",
                          _LAUNCH_ARGS)
    err = fn(D.data_ptr(), U.data_ptr(), B.data_ptr(), X.data_ptr(),
             work.data_ptr(), piv.data_ptr(), N, m, L, P,
             kernels.stream(B.device))
    kernels.check(err, "block_tridiag")
    kernels.LAUNCHES["block_tridiag"] += 1
    return X


# ------------------------------------------- split launches (phases 1, 3)
_OFFSET_ARGS = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def _check_split(D: Tensor, U: Tensor, B: Tensor) -> None:
    N = B.shape[0]
    if D.shape != (N, 6, 6) or U.shape != (max(N - 1, 0), 6, 6) or \
            B.dim() != 3 or B.shape[1] != 6 or N < 2 or B.shape[2] < 1:
        raise ValueError(f"block_tridiag_condense: D (N,6,6), U (N-1,6,6), "
                         f"B (N,6,m) with N >= 2 expected, got "
                         f"{tuple(D.shape)}, {tuple(U.shape)}, "
                         f"{tuple(B.shape)}")


def block_tridiag_condense_plain(D: Tensor, U: Tensor, B: Tensor,
                                 seg_len: Optional[int] = None) -> Condensed:
    """Plain version of ``block_tridiag_condense``."""
    _check_split(D, U, B)
    N = B.shape[0]
    L, P = segments(N, seg_len)
    Dg, Ug, Bg, res = _condense_plain(D, U, B, L, P)
    return Condensed(Dg, Ug, Bg, U, N, L, P, res)


def block_tridiag_backsub_plain(cond: Condensed, xg: Tensor) -> Tensor:
    """Plain version of ``block_tridiag_backsub``."""
    return _backsub_plain(cond.U, cond.N, cond.res, xg)


def block_tridiag_condense(D: Tensor, U: Tensor, B: Tensor,
                           seg_len: Optional[int] = None) -> Condensed:
    """Phase 1 alone: the N >= 2 blocks condensed segment by segment onto
    their separator chain of 2P blocks (``Condensed``). One kernel launch
    on a CUDA tensor (the one-launch path's condensation, no grid
    barrier), the plain version on a CPU tensor. Solve the chain (for
    ``xg``), then ``block_tridiag_backsub``."""
    if B.device.type == "cpu":
        return block_tridiag_condense_plain(D, U, B, seg_len)
    _check_split(D, U, B)
    N, m = B.shape[0], B.shape[2]
    if any(t.dtype != torch.float32 or t.device != B.device
           for t in (D, U, B)) or m > MAX_RHS:
        raise ValueError("block_tridiag_condense: D, U, B must be float32 "
                         f"on one device, with at most {MAX_RHS} columns")
    L, P = segments(N, seg_len)
    D, U, B = D.contiguous(), U.contiguous(), B.contiguous()
    nf, ni = ctypes.c_longlong(), ctypes.c_longlong()
    kernels.check(kernels.function(
        "block_tridiag", "block_tridiag_scratch", _SCRATCH_ARGS)(
        N, m, L, P, ctypes.addressof(nf), ctypes.addressof(ni)),
        "block_tridiag scratch")
    work = torch.empty(nf.value, dtype=torch.float32, device=B.device)
    piv = torch.empty(ni.value, dtype=torch.int32, device=B.device)
    fn = kernels.function("block_tridiag", "block_tridiag_condense_launch",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p])
    kernels.check(fn(D.data_ptr(), U.data_ptr(), B.data_ptr(),
                     work.data_ptr(), piv.data_ptr(), N, m, L, P,
                     kernels.stream(B.device)), "block_tridiag_condense")
    kernels.LAUNCHES["block_tridiag_condense"] += 1
    off = [ctypes.c_longlong() for _ in range(3)]
    kernels.check(kernels.function(
        "block_tridiag", "block_tridiag_sep_offsets", _OFFSET_ARGS)(
        N, m, L, P, *(ctypes.addressof(o) for o in off)),
        "block_tridiag offsets")
    od, ou, ob = (o.value for o in off)
    Dg = work[od:od + 2 * P * 36].view(2 * P, 6, 6)
    Ug = work[ou:ou + (2 * P - 1) * 36].view(2 * P - 1, 6, 6)
    Bg = work[ob:ob + 2 * P * 6 * m].view(2 * P, 6, m)
    return Condensed(Dg, Ug, Bg, U, N, L, P, (work, piv))


def block_tridiag_backsub(cond: Condensed, xg: Tensor) -> Tensor:
    """Phase 3 alone: X (N, 6, m) from ``block_tridiag_condense``'s state
    and the solved separator blocks ``xg`` (2P, 6, m). One kernel launch
    on a CUDA tensor, the plain version on a CPU tensor."""
    if xg.shape != cond.Bg.shape:
        raise ValueError(f"block_tridiag_backsub: xg {tuple(xg.shape)} "
                         f"expected {tuple(cond.Bg.shape)}")
    if xg.device.type == "cpu":
        return block_tridiag_backsub_plain(cond, xg)
    if xg.dtype != torch.float32 or xg.device != cond.U.device:
        raise ValueError("block_tridiag_backsub: xg must be float32 on the "
                         "condensed system's device")
    work, piv = cond.res
    N, m = cond.N, xg.shape[2]
    xg = xg.contiguous()
    X = xg.new_empty((N, 6, m))
    fn = kernels.function("block_tridiag", "block_tridiag_backsub_launch",
                          [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                          + [ctypes.c_void_p])
    kernels.check(fn(cond.U.data_ptr(), xg.data_ptr(), X.data_ptr(),
                     work.data_ptr(), piv.data_ptr(), N, m, cond.L, cond.P,
                     kernels.stream(xg.device)), "block_tridiag_backsub")
    kernels.LAUNCHES["block_tridiag_backsub"] += 1
    return X


def launch_geometry(N: int, m: int, seg_len: Optional[int] = None) -> dict:
    """The cooperative launch for N blocks and m right-hand sides: segment
    length and count, chain depth, grid blocks, threads, dynamic shared
    memory bytes, registers and local bytes per thread, blocks an SM
    holds."""
    L, P = segments(N, seg_len)
    out = [ctypes.c_int() for _ in range(6)]
    fn = kernels.function("block_tridiag", "block_tridiag_geometry",
                          [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6)
    kernels.check(fn(m, P, *(ctypes.addressof(o) for o in out)),
                  "block_tridiag geometry")
    return dict(seg_len=L, segments=P, chain_depth=chain_depth(N, L, P),
                **dict(zip(("blocks", "threads", "smem", "regs", "local",
                            "per_sm"), (o.value for o in out))))
