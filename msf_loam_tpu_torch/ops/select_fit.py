"""Fused k-NN selection + line/plane fit: ``csrc/select_fit.cu`` on a CUDA
tensor, the plain PyTorch version below on a CPU tensor.

Replaces the Pallas kernel ``msf_loam_tpu/ops/select_fit.py``
(``select_fit_pallas``). Candidates arrive either as planar (3, N, C) or
as rows (N, 3C) packed [x*C | y*C | z*C]; invalid candidates carry
coordinates >= 1e9. Per query: the k ascending squared distances within
the strict radius, 0/1 k-NN weights, query-relative centred moments, the
closed-form 3x3 eigensolve (8 Newton steps for cos(acos(r)/3), following
the kernel rather than ``fitting.eigh3x3``'s arccos) and the mode's gates.
``select_fit_pair`` runs two such problems (a mapping round's corner and
surface calls) in one kernel launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from msf_loam_tpu_torch import kernels

Tensor = torch.Tensor

_INF = 3.0e38
_MODES = {"line": 0, "plane": 1, "plane2": 2}


class SelectFit(NamedTuple):
    d2: Tensor        # (N, k) ascending squared distances (strict radius)
    center: Tensor    # (N, 3) fit centroid (world frame)
    normal: Tensor    # (N, 3) line direction / plane normal
    valid: Tensor     # (N,) bool


def _eig3(sxx, syy, szz, sxy, sxz, syz):
    """Eigenvalues (descending) of a symmetric 3x3, elementwise."""
    p1 = sxy * sxy + sxz * sxz + syz * syz
    qm = (sxx + syy + szz) / 3.0
    p2 = ((sxx - qm) ** 2 + (syy - qm) ** 2 + (szz - qm) ** 2 + 2.0 * p1)
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    b00, b11, b22 = (sxx - qm) / p, (syy - qm) / p, (szz - qm) / p
    b01, b02, b12 = sxy / p, sxz / p, syz / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    # c = cos(acos(r)/3): the largest root of 4c^3 - 3c = r on [0.5, 1],
    # Newton from c = 1 (the Pallas kernel's method)
    c = torch.ones_like(r)
    for _ in range(8):
        c = c - (4.0 * c * c * c - 3.0 * c - r) / torch.clamp(
            12.0 * c * c - 3.0, min=1e-6)
        c = torch.clamp(c, 0.5, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - c * c, min=0.0))
    w0 = qm + 2.0 * p * c
    w2 = qm + 2.0 * p * (-0.5 * c - 0.8660254037844386 * s)
    w1 = 3.0 * qm - w0 - w2
    d0 = torch.maximum(torch.maximum(sxx, syy), szz)
    d2_ = torch.minimum(torch.minimum(sxx, syy), szz)
    d1 = sxx + syy + szz - d0 - d2_
    is_diag = p1 < 1e-12
    return (torch.where(is_diag, d0, w0), torch.where(is_diag, d1, w1),
            torch.where(is_diag, d2_, w2))


def _eigvec(sxx, syy, szz, sxy, sxz, syz, wj, wk):
    """Unit eigenvector of the remaining eigenvalue: the dominant column of
    (A - wj I)(A - wk I); e_x when degenerate."""
    a = [[sxx - wj, sxy, sxz], [sxy, syy - wj, syz], [sxz, syz, szz - wj]]
    b = [[sxx - wk, sxy, sxz], [sxy, syy - wk, syz], [sxz, syz, szz - wk]]
    m = [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
          for j in range(3)] for i in range(3)]
    n0 = m[0][0] ** 2 + m[1][0] ** 2 + m[2][0] ** 2
    n1 = m[0][1] ** 2 + m[1][1] ** 2 + m[2][1] ** 2
    n2 = m[0][2] ** 2 + m[1][2] ** 2 + m[2][2] ** 2
    pick0 = (n0 >= n1) & (n0 >= n2)
    pick1 = ~pick0 & (n1 >= n2)
    v = [torch.where(pick0, m[i][0], torch.where(pick1, m[i][1], m[i][2]))
         for i in range(3)]
    nrm2 = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
    nrm = torch.sqrt(torch.clamp(nrm2, min=0.0))   # 1e-60 is 0 in float32
    ok = nrm2 > 1e-40
    one, zero = torch.ones_like(nrm), torch.zeros_like(nrm)
    return (torch.where(ok, v[0] / nrm, one), torch.where(ok, v[1] / nrm, zero),
            torch.where(ok, v[2] / nrm, zero))


def _moments(w, dx, dy, dz):
    cnt = w.sum(dim=1)
    cd = 1.0 / torch.clamp(cnt, min=1.0)
    mx = (w * dx).sum(dim=1) * cd
    my = (w * dy).sum(dim=1) * cd
    mz = (w * dz).sum(dim=1) * cd
    rx, ry, rz = dx - mx[:, None], dy - my[:, None], dz - mz[:, None]
    s = tuple((w * u * v).sum(dim=1) for u, v in
              ((rx, rx), (ry, ry), (rz, rz), (rx, ry), (rx, rz), (ry, rz)))
    return cnt, (mx, my, mz), s


def _resid(n, m, dx, dy, dz):
    return (n[0][:, None] * (dx - m[0][:, None])
            + n[1][:, None] * (dy - m[1][:, None])
            + n[2][:, None] * (dz - m[2][:, None])).abs()


def select_fit_plain(x: Tensor, y: Tensor, z: Tensor, query: Tensor,
                     r2s: float, r2w: float, *, k: int, mode: str,
                     min_count: int, min_wide: int, eig_ratio: float,
                     tol: float, cond_frac: float) -> SelectFit:
    """Plain PyTorch version over (N, C) candidate coordinate planes."""
    dx = x - query[:, 0:1]
    dy = y - query[:, 1:2]
    dz = z - query[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    inf = torch.full((), _INF, device=x.device)
    d2s = torch.where(d2 <= r2s, d2, inf)
    cur = d2s
    vals = []
    for _ in range(k):
        v = cur.min(dim=1, keepdim=True).values
        vals.append(v)
        cur = torch.where(cur <= v, inf, cur)
    d2k = torch.cat(vals, dim=1)
    w = ((d2s <= vals[-1]) & (d2s < _INF * 0.5)).float()

    cnt, mean, s = _moments(w, dx, dy, dz)
    e0, e1, e2 = _eig3(*s)
    if mode == "line":
        nrm = _eigvec(*s, e1, e2)
        valid = (cnt >= min_count) & (e0 > eig_ratio * e1)
        cen = mean
    else:
        nrm = _eigvec(*s, e0, e1)
        maxres = (_resid(nrm, mean, dx, dy, dz) * w).max(dim=1).values
        valid = (cnt >= min_count) & (maxres <= tol) & (e1 > cond_frac * e0)
        cen = mean
        if mode == "plane2":
            ww = (d2 <= r2w).float()
            cntw, wmean, sw = _moments(ww, dx, dy, dz)
            v0, v1, _ = _eig3(*sw)
            wn = _eigvec(*sw, v0, v1)
            rr = _resid(wn, wmean, dx, dy, dz)
            res_w = (rr * ww).max(dim=1).values
            res_n = (rr * w).max(dim=1).values
            fb_ok = ((cntw >= min_wide) & (v1 > cond_frac * v0)
                     & (res_w <= tol) & (res_n <= tol))
            use_fb = ~valid & fb_ok
            cen = tuple(torch.where(use_fb, a, b) for a, b in zip(wmean, cen))
            nrm = tuple(torch.where(use_fb, a, b) for a, b in zip(wn, nrm))
            valid = valid | use_fb
    center = torch.stack(cen, dim=1) + query
    return SelectFit(d2k, center, torch.stack(nrm, dim=1), valid)


def _f32(v) -> float:
    return float(np.float32(v))


class _Problem(ctypes.Structure):
    """One problem of a launch (``SelectFitProblem`` in csrc/select_fit.cu)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "cx", "cy", "cz")]
                + [("row_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("N", "C", "k", "mode",
                                               "min_count", "min_wide")]
                + [(n, ctypes.c_float) for n in ("eig_ratio", "tol",
                                                 "cond_frac", "r2s", "r2w")]
                + [(n, ctypes.c_void_p) for n in ("d2k", "cen", "nrm",
                                                  "valid")])


_LAUNCH_ARGS = [ctypes.POINTER(_Problem), ctypes.POINTER(_Problem),
                ctypes.c_void_p]


class _Spec(NamedTuple):
    cand: Tensor
    query: Tensor
    rows: bool
    N: int
    C: int
    r2s: float
    r2w: float
    gates: dict


def _spec(cand: Tensor, query: Tensor, r2_strict: float, r2_wide: float, *,
          k: int = 5, mode: str = "plane2", min_count: int = 5,
          min_wide: int = 5, eig_ratio: float = 3.0, tol: float = 0.2,
          cond_frac: float = 0.05) -> _Spec:
    rows = cand.dim() == 2
    if rows:
        N, C = cand.shape[0], cand.shape[1] // 3
    else:
        N, C = cand.shape[1], cand.shape[2]
    gates = dict(k=k, mode=mode, min_count=min_count, min_wide=min_wide,
                 eig_ratio=_f32(eig_ratio), tol=_f32(tol),
                 cond_frac=_f32(cond_frac))
    return _Spec(cand, query, rows, N, C, _f32(r2_strict), _f32(r2_wide),
                 gates)


def _plain(sp: _Spec) -> SelectFit:
    cand, C = sp.cand, sp.C
    if sp.rows:
        x, y, z = cand[:, :C], cand[:, C:2 * C], cand[:, 2 * C:]
    else:
        x, y, z = cand[0], cand[1], cand[2]
    return select_fit_plain(x, y, z, sp.query, sp.r2s, sp.r2w, **sp.gates)


def _run(specs) -> tuple:
    """Every problem of ``specs`` (one or two) in one kernel launch on a
    CUDA tensor; the plain version, once per problem, on a CPU tensor."""
    dev = specs[0].cand.device
    if any(sp.cand.device != dev for sp in specs):
        raise ValueError("select_fit_pair: both problems on one device")
    if dev.type == "cpu":
        return tuple(_plain(sp) for sp in specs)
    for sp in specs:
        cand, query = sp.cand, sp.query
        if cand.dtype != torch.float32 or not cand.is_contiguous() or \
                query.shape != (sp.N, 3) or query.dtype != torch.float32 or \
                not query.is_contiguous() or query.device != dev:
            raise ValueError("select_fit: cand must be contiguous float32 "
                             "(3, N, C) or (N, 3C), query contiguous (N, 3) "
                             "float32, all on one device")
    # every output of the launch is a view of one allocation:
    # per problem d2 (N, k), centre (N, 3), normal (N, 3), then the flags
    sizes = [sp.N * (sp.gates["k"] + 6) for sp in specs]
    flag_words = [-(-sp.N // 4) for sp in specs]
    buf = torch.empty(sum(sizes) + sum(flag_words), dtype=torch.float32,
                      device=dev)
    parts = buf.split(sizes + flag_words)
    outs, probs = [], []
    for sp, p, f in zip(specs, parts, parts[len(specs):]):
        N, k = sp.N, sp.gates["k"]
        d2k, cen, nrm = p.split([N * k, 3 * N, 3 * N])
        out = SelectFit(d2k.view(N, k), cen.view(N, 3), nrm.view(N, 3),
                        f.view(torch.uint8)[:N].view(torch.bool))
        base = sp.cand.data_ptr()
        if sp.rows:
            ptrs, stride = (base, base + 4 * sp.C, base + 8 * sp.C), 3 * sp.C
        else:
            ptrs = (base, base + 4 * N * sp.C, base + 8 * N * sp.C)
            stride = sp.C
        g = sp.gates
        probs.append(_Problem(
            sp.query.data_ptr(), *ptrs, stride, N, sp.C, k, _MODES[g["mode"]],
            g["min_count"], g["min_wide"], g["eig_ratio"], g["tol"],
            g["cond_frac"], sp.r2s, sp.r2w, *(t.data_ptr() for t in out)))
        outs.append(out)
    fn = kernels.function("select_fit", "select_fit_launch", _LAUNCH_ARGS)
    err = fn(ctypes.byref(probs[0]),
             ctypes.byref(probs[1]) if len(probs) > 1 else None,
             kernels.stream(dev))
    kernels.check(err, "select_fit")
    kernels.LAUNCHES["select_fit"] += 1
    return tuple(outs)


def select_fit(cand: Tensor, query: Tensor, r2_strict: float,
               r2_wide: float, **kw) -> SelectFit:
    """Fused selection + fit.

    Args:
      cand: (3, N, C) planar or (N, 3C) rows f32 candidate coordinates;
        invalid candidates carry coordinates >= 1e9.
      query: (N, 3) f32 world-frame query points.
      r2_strict / r2_wide: squared radii (rounded to float32).
      kw: k (5), mode ("plane2"), min_count (5), min_wide (5), eig_ratio
        (3.0), tol (0.2), cond_frac (0.05).
    """
    return _run((_spec(cand, query, r2_strict, r2_wide, **kw),))[0]


def select_fit_pair(cand_a: Tensor, query_a: Tensor, r2_strict_a: float,
                    r2_wide_a: float, kw_a: dict, cand_b: Tensor,
                    query_b: Tensor, r2_strict_b: float, r2_wide_b: float,
                    kw_b: dict) -> tuple:
    """Two independent ``select_fit`` problems (``kw_a`` / ``kw_b``: their
    keyword arguments) in one kernel launch on CUDA tensors: the mapping
    round's corner and surface calls. On CPU tensors, the plain version
    once per problem, so the results equal two ``select_fit`` calls."""
    return _run((_spec(cand_a, query_a, r2_strict_a, r2_wide_a, **kw_a),
                 _spec(cand_b, query_b, r2_strict_b, r2_wide_b, **kw_b)))


def launch_geometry(Na: int, Ca: int, Nb: int = 0, Cb: int = 0) -> dict:
    """Lanes per query, candidates per lane, blocks, threads, static shared
    memory bytes, registers and local (spill) bytes per thread and
    resident blocks per SM of the launch at these sizes (on the current
    CUDA device)."""
    out = (ctypes.c_int * 8)()
    fn = kernels.function("select_fit", "select_fit_geometry",
                          [ctypes.c_int] * 4 + [ctypes.c_void_p])
    kernels.check(fn(Na, Ca, Nb, Cb, out), "select_fit geometry")
    return dict(zip(("G", "P", "blocks", "threads", "smem", "regs", "local",
                     "per_sm"), out))
