"""The decompositions of the hand-written kernels, held to the plain
versions on the CPU.

``csrc/pick_rounds.cu`` does not run the pick rounds as iterated argmaxes:
it sorts each sector's valid columns once per score plane as 64-bit keys,
stores the runs in sector order and walks them from a per-sector cursor
with 32-wide ballots, finding dominating picks through a column -> pick
map.
``csrc/odo_corr.cu`` splits the reference cloud into slices over the
blocks of a thread-block cluster, scans each slice in 8 warp segments and
merges the minima in index order.
``csrc/select_fit.cu`` gives each query a group of G lanes, compacts the
in-radius candidates in index order, sums each lane's candidates in
order and the lanes' partials pairwise (xor distances 1, 2, 4, ...), and
serves two problems from one launch.
``csrc/knn.cu`` bounds each query's k-th distance from a sample of every
ref segment, then scans the segments (8 blocks x 4 warps, R queries a
thread) 32 refs at a time against a stale threshold, inserting with the
strict rule, and merges the lists in index order.
The numpy mirrors below do exactly those steps, so the CPU suite checks
the decompositions themselves, on seeded adversarial inputs, against
``pick_rounds_plain``, ``odo_corr_plain``, ``select_fit_plain`` and
``knn_plain`` (which the JAX package's kernels hold in
``test_torch_features.py``, ``test_torch_odometry.py``,
``test_torch_mapping.py`` and ``test_torch_knn.py``).
"""

import numpy as np
import pytest
import torch

from msf_loam_tpu_torch.ops import select_fit as sfm
from msf_loam_tpu_torch.ops.odo_corr import odo_corr_plain, ref_planes
from msf_loam_tpu_torch.ops.pallas_knn import knn_plain, launch_plan
from msf_loam_tpu_torch.ops.pick_rounds import pick_rounds_plain

_BIG = np.float32(1e18)
_COL_BITS = np.uint64(22)
_SEC_SHIFT = np.uint64(54)
_COL_MASK = np.uint64((1 << 22) - 1)
_U32 = np.uint64(0xFFFFFFFF)
_SIGN = np.uint64(0x80000000)


# ------------------------------------------------------------ pick_rounds
def _sorted_runs(score, sector, S):
    """The kernel's keys (sector | descending score bits with -0 as +0 |
    column) of each sector's valid columns, each run sorted ascending and
    the runs stored in sector order; returns the keys and the run starts."""
    col = np.arange(score.shape[0], dtype=np.uint64)
    canon = np.where(score == 0, np.float32(0), score).astype(np.float32)
    u = canon.view(np.uint32).astype(np.uint64)
    asc = np.where(u & _SIGN, ~u & _U32, u | _SIGN)
    ok = (score > -0.5 * _BIG) & (sector >= 0) & (sector < S)
    key = (sector.astype(np.uint64) << _SEC_SHIFT) | \
        ((~asc & _U32) << _COL_BITS) | col
    runs = [np.sort(key[ok & (sector == s)]) for s in range(S)]
    starts = np.cumsum([0] + [len(r) for r in runs])
    return np.concatenate(runs), [int(x) for x in starts]


def _key_score(key):
    asc = ~(key >> _COL_BITS) & _U32
    bits = np.where(asc & _SIGN, asc & ~_SIGN & _U32, ~asc & _U32)
    return bits.astype(np.uint32).view(np.float32)


def _walk_row(sc, sf, sec, cb0, S, nsup, n_sharp, n_rest_rounds, rest_T,
              n_flat):
    """One ring row as the kernel's block runs it."""
    W = sc.shape[0]
    sup = np.zeros(W, bool)
    rows, sup_corner = [], None
    phases = ((sc, [1] * n_sharp + [rest_T] * n_rest_rounds),
              (sf, [1] * n_flat))
    for plane, (score, round_T) in enumerate(phases):
        if plane == 1:
            sup_corner = sup.copy()
        ord_, lo = _sorted_runs(score, sec, S)
        cur = lo[:S]
        for T in round_T:
            fi = np.full(S * T, -1)
            fv = np.full(S * T, -_BIG, np.float32)
            fok = np.zeros(S * T, bool)
            fcb = np.zeros(S * T, np.int64)
            for s in range(S):
                end = lo[s + 1]
                pos, got, first = cur[s], 0, end
                while got < T and pos < end:            # one ballot window
                    win = ord_[pos:min(pos + 32, end)]
                    cols = (win & _COL_MASK).astype(np.int64)
                    free = np.flatnonzero(~sup[cols])
                    if free.size and first == end:
                        first = pos + int(free[0])
                    for rank, b in enumerate(free):     # popcount ranks
                        p = s * T + got + rank
                        if got + rank < T:
                            fi[p], fv[p] = cols[b], _key_score(win[b])
                            fok[p], fcb[p] = True, cb0[cols[b]]
                    got += free.size
                    pos += 32
                cur[s] = first
            pmap = {fi[p]: p for p in np.flatnonzero(fok)}  # column -> pick
            keep = fok.copy()
            for p in np.flatnonzero(fok):
                for d in [*range(-nsup, 0), *range(1, nsup + 1)]:
                    q = pmap.get(fi[p] + d)
                    if q is not None and fcb[q] == fcb[p] and (
                            fv[q] > fv[p] or (fv[q] == fv[p] and d < 0)):
                        keep[p] = False
            for p in np.flatnonzero(keep):
                w = np.arange(fi[p] - nsup, fi[p] + nsup + 1)
                w = w[(w >= 0) & (w < W)]
                sup[w[cb0[w] == fcb[p]]] = True
            rows.append(np.where(keep, fi, -1).reshape(S, T).T)
    return np.concatenate(rows), sup_corner


def _pick_case(name, rng, R=4, W=192, S=6):
    """Seeded planes for one adversarial case: (score_c, score_f, sector,
    cb0)."""
    curv = (rng.integers(0, 6, (R, W)) * 0.25).astype(np.float32)
    sec = np.sort(rng.integers(0, S, (R, W)), axis=1)
    sec[:, :5] = -1
    ok = rng.uniform(size=(R, W)) > 0.2
    cb0 = np.cumsum(rng.uniform(size=(R, W)) > 0.9, axis=1)
    if name == "signed_zeros":
        # score_f = -curv is -0.0 wherever curv is 0; +0.0 planted beside
        curv[:, ::3] = 0.0
        curv[:, 1::7] = -0.0
    elif name == "interleaved_sectors":
        sec = rng.integers(-1, S, (R, W))
    elif name == "empty_and_thin_sectors":
        sec = np.where(sec == 2, 3, sec)                     # no sector 2
        thin = np.flatnonzero(sec[0] == 4)
        ok[0, sec[0] == 4] = False
        ok[0, thin[:3]] = True                               # 3 < T = 6 valid
        curv[0, thin[:3]] = 1.0
    elif name == "boundary_suppression":
        # every column pickable and tied: picks crowd the sector boundaries,
        # whose +-nsup windows cross into the next sector; a broken gap
        # chain every 7 columns stops some of them
        curv[:] = 1.0
        curv[:, ::2] = 0.0
        ok[:] = True
        cb0 = np.cumsum((np.arange(W) % 7) == 0)[None, :].repeat(R, 0)
    neg = np.float32(-1e18)
    score_c = np.where(ok & (curv > 0.3), curv, neg).astype(np.float32)
    score_f = np.where(ok & (curv < 0.1), -curv, neg).astype(np.float32)
    return score_c, score_f, sec.astype(np.int32), cb0.astype(np.int32)


@pytest.mark.parametrize("case", ["ties", "signed_zeros",
                                  "interleaved_sectors",
                                  "empty_and_thin_sectors",
                                  "boundary_suppression"])
def test_sorted_sector_walk_matches_plain_pick_rounds(case):
    rng = np.random.default_rng(7)
    score_c, score_f, sec, cb0 = _pick_case(case, rng)
    if case == "signed_zeros":
        assert (np.signbit(score_f) & (score_f == 0)).any()
        assert (~np.signbit(score_f) & (score_f == 0)).any()
    kw = dict(S=6, nsup=5, n_sharp=2, n_rest=18, rest_T=6, n_flat=4)
    corner, flat, sup = pick_rounds_plain(
        *(torch.from_numpy(a) for a in (score_c, score_f, sec, cb0)), **kw)
    want = np.concatenate([corner.numpy(), flat.numpy()])
    for r in range(score_c.shape[0]):
        got, got_sup = _walk_row(score_c[r], score_f[r], sec[r], cb0[r], 6, 5,
                                 2, 3, 6, 4)
        np.testing.assert_array_equal(got, want[:, r, :], err_msg=f"row {r}")
        np.testing.assert_array_equal(got_sup, sup.numpy()[r])
    assert (want >= 0).any() and (want < 0).any()


# --------------------------------------------------------------- odo_corr
_WARPS, _TILE, _INF = 8, 32, np.float32(3e38)


def _scan(d2, ok, init_v, init_i, base):
    """Each warp's strict-< scan in index order over its segment: d2 and ok
    are (N, C, 8, seg); returns (value, index) per (N, C, 8)."""
    v = np.full(d2.shape[:3], init_v, np.float32)
    i = np.broadcast_to(init_i, d2.shape[:3]).copy()
    for j in range(d2.shape[3]):
        take = ok[..., j] & (d2[..., j] < v)
        v = np.where(take, d2[..., j], v)
        i = np.where(take, base + j, i)
    return v, i


def _merge(v, i):
    """Strict-< merge along the last axis in order (lower index on ties)."""
    bv, bi = v[..., 0].copy(), i[..., 0].copy()
    for c in range(1, v.shape[-1]):
        take = v[..., c] < bv
        bv, bi = np.where(take, v[..., c], bv), np.where(take, i[..., c], bi)
    return bv, bi


def _cluster_odo(q, planes, K, C, nearby):
    """The kernel's cluster decomposition, tiles of 32 queries padded."""
    N, M = q.shape[0], planes.shape[1]
    n_pad = -(-N // _TILE) * _TILE
    qp = np.zeros((n_pad, 3), np.float32)
    qp[:N] = q
    L, seg = M // C, M // C // _WARPS
    idx = np.arange(M).reshape(C, _WARPS, seg)
    base = idx[..., 0][None]                                  # (1, C, 8)
    rx, ry, rz, rr = (p[idx][None] for p in planes)           # (1, C, 8, seg)
    dx, dy, dz = (r - qp[:, k, None, None, None]
                  for k, r in enumerate((rx, ry, rz)))
    d2 = dx * dx + dy * dy + dz * dz
    pv, pi = _scan(d2, np.ones(d2.shape, bool), np.inf, base, base)
    nb = K // C if K else 1
    wpb = _WARPS // nb
    bv, bi = _merge(pv.reshape(n_pad, C, nb, wpb),
                    pi.reshape(n_pad, C, nb, wpb))            # per bin
    sv, si = _merge(bv, bi)                                   # per slice
    av, ai = _merge(sv, si)                                   # slice order
    ring_a = planes[3][ai]
    dr = np.abs(rr - ring_a[:, None, None, None])
    ok = (dr > 0) & (dr <= np.float32(nearby))
    cv, ci = _scan(d2, ok, _INF, np.int64(M), base)
    cv, ci = _merge(*_merge(cv, ci))                          # warps, slices
    cand = (bv.reshape(n_pad, K), bi.reshape(n_pad, K),
            planes[3][bi.reshape(n_pad, K)].astype(np.int32)) if K else None
    assert L == nb * wpb * seg
    return av[:N], ai[:N], ring_a[:N].astype(np.int32), cv[:N], ci[:N], \
        tuple(c[:N] for c in cand) if K else None


def _odo_case(rng, M0, K):
    """Reference cloud with adversarial structure and a ragged query set."""
    xyz = rng.uniform(-8, 8, (M0, 3)).astype(np.float32)
    ring = rng.integers(0, 16, M0).astype(np.int32)
    mask = rng.uniform(size=M0) > 0.1
    M = M0 + (-M0) % (K * 128 if K else 128)
    L16, L8 = M // 16, M // 8
    for cut in (L16, 3 * L8, 5 * L16):      # duplicates across slice edges
        xyz[cut - 1] = xyz[cut] = xyz[cut + 5]
        ring[cut - 1] = ring[cut] = ring[cut + 5]
        mask[cut - 1] = mask[cut] = mask[cut + 5] = True
    mask[2 * L16:3 * L16] = False           # an all-sentinel slice
    ring[-40:] = 100                        # a ring with no nearby partner
    mask[-40:] = True
    N = 77
    q = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    q[:10] = xyz[-40:-30]                   # nearest on ring 100: no partner
    q[10:20] = xyz[L16 + 5]                 # on duplicates across slices
    q[20:30] = xyz[3 * L8 + 5]
    return q, xyz, mask, ring


@pytest.mark.parametrize("C", [16, 8])
@pytest.mark.parametrize("K", [0, 16])
def test_cluster_slice_split_matches_plain_odo_corr(K, C):
    rng = np.random.default_rng(11 + K)
    q, xyz, mask, ring = _odo_case(rng, 1000 if K == 0 else 2000, K)
    planes = ref_planes(torch.from_numpy(xyz), torch.from_numpy(mask),
                        torch.from_numpy(ring), K)
    want = odo_corr_plain(torch.from_numpy(q), planes, K, 2.5)
    av, ai, ar, cv, ci, cand = _cluster_odo(q, planes.numpy(), K, C, 2.5)
    M = planes.shape[1]
    np.testing.assert_array_equal(ai, want.a_idx.numpy())
    np.testing.assert_array_equal(ar, want.a_ring.numpy())
    np.testing.assert_array_equal(ci, want.c_idx.numpy())
    np.testing.assert_array_equal(av.view(np.uint32),
                                  want.a_d2.numpy().view(np.uint32))
    np.testing.assert_array_equal(cv.view(np.uint32),
                                  want.c_d2.numpy().view(np.uint32))
    assert (ci[:10] == M).all() and (cv[:10] == _INF).all()
    L16, L8 = M // 16, M // 8
    assert (ai[10:20] == L16 - 1).all() and (ai[20:30] == 3 * L8 - 1).all()
    if K:
        np.testing.assert_array_equal(cand[0].view(np.uint32),
                                      want.cand_d2.numpy().view(np.uint32))
        np.testing.assert_array_equal(cand[1], want.cand_idx.numpy())
        np.testing.assert_array_equal(cand[2], want.cand_ring.numpy())


# ------------------------------------------------------------- select_fit
_F = np.float32


def _lane_tree(part):
    """(N, G) lane partials -> (N,) sums, lanes paired at xor distance 1,
    then 2, 4, ... (each level adds adjacent pairs of the previous)."""
    while part.shape[1] > 1:
        part = part[:, 0::2] + part[:, 1::2]
    return part[:, 0]


def _lane_sums(vals, G):
    """(N, n) values in compacted order (zeros where unweighted) -> (N,)
    sums as the kernel adds them: lane li takes entries li, li + G, ... in
    order, then the lane tree."""
    N, n = vals.shape
    P = max(1, -(-n // G))
    padded = np.zeros((N, P * G), _F)
    padded[:, :n] = vals
    part = np.zeros((N, G), _F)
    for j in range(P):
        part = part + padded[:, j * G:(j + 1) * G]
    return _lane_tree(part)


def _group_fit(x, y, z, q, r2s, r2w, G, k, mode, min_count, min_wide,
               eig_ratio, tol, cond_frac):
    """select_fit.cu's decomposition for (N, C) candidate planes, one query
    per group of G lanes: its compaction and summation order; the 3x3
    eigensolve is the plain version's (the kernel's reciprocals differ
    from it by a few ulp)."""
    N, C = x.shape
    dx, dy, dz = x - q[:, 0:1], y - q[:, 1:2], z - q[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    rA = max(r2s, r2w) if mode == "plane2" else r2s
    inA = d2 <= _F(rA)
    # compaction: in-radius candidates to the front, index order kept
    order = np.argsort(~inA, axis=1, kind="stable")
    nA = inA.sum(axis=1)
    live = np.arange(C)[None, :] < nA[:, None]
    cdx, cdy, cdz, cd2 = (np.take_along_axis(a, order, 1) for a in
                          (dx, dy, dz, d2))
    cd2 = np.where(live, cd2, _F(np.inf))
    s_in = live & (cd2 <= _F(r2s))
    cur = np.where(s_in, cd2, _F(3e38))
    w_in = s_in & (cd2 < _F(1.5e38))
    wide = live & (cd2 <= _F(r2w))
    d2k = []
    for _ in range(k):
        v = np.minimum(cur.min(axis=1), _F(3e38))
        d2k.append(v)
        cur = np.where(cur <= v[:, None], _F(np.inf), cur)
    w = w_in & (cur == np.inf)

    def moments(wt):
        one = wt.astype(_F)
        cnt = _lane_sums(one, G)
        cd = _F(1) / np.maximum(cnt, _F(1))
        mean = [_lane_sums(np.where(wt, u, _F(0)), G) * cd
                for u in (cdx, cdy, cdz)]
        r = [u - m[:, None] for u, m in zip((cdx, cdy, cdz), mean)]
        sec = [_lane_sums(np.where(wt, a * b, _F(0)), G) for a, b in
               ((r[0], r[0]), (r[1], r[1]), (r[2], r[2]), (r[0], r[1]),
                (r[0], r[2]), (r[1], r[2]))]
        return cnt, mean, [torch.from_numpy(v) for v in sec]

    def resid(nrm, mean):
        return np.abs(nrm[0][:, None] * (cdx - mean[0][:, None])
                      + nrm[1][:, None] * (cdy - mean[1][:, None])
                      + nrm[2][:, None] * (cdz - mean[2][:, None]))

    cnt, mean, sec = moments(w)
    e0, e1, e2 = (t.numpy() for t in sfm._eig3(*sec))
    if mode == "line":
        nrm = [t.numpy() for t in sfm._eigvec(*sec, torch.from_numpy(e1),
                                             torch.from_numpy(e2))]
        valid = (cnt >= min_count) & (e0 > _F(eig_ratio) * e1)
        cen = mean
    else:
        nrm = [t.numpy() for t in sfm._eigvec(*sec, torch.from_numpy(e0),
                                             torch.from_numpy(e1))]
        rr = resid(nrm, mean)
        maxres = np.where(w, rr, _F(0)).max(axis=1)
        valid = (cnt >= min_count) & (maxres <= _F(tol)) & \
            (e1 > _F(cond_frac) * e0)
        cen = mean
        if mode == "plane2":
            cw, wmean, wsec = moments(wide)
            v0, v1, _ = (t.numpy() for t in sfm._eig3(*wsec))
            wn = [t.numpy() for t in sfm._eigvec(*wsec, torch.from_numpy(v0),
                                                torch.from_numpy(v1))]
            rw = resid(wn, wmean)
            res_w = np.where(wide, rw, _F(0)).max(axis=1)
            res_n = np.where(w, rw, _F(0)).max(axis=1)
            fb = (~valid & (cw >= min_wide) & (v1 > _F(cond_frac) * v0)
                  & (res_w <= _F(tol)) & (res_n <= _F(tol)))
            cen = [np.where(fb, a, b) for a, b in zip(wmean, cen)]
            nrm = [np.where(fb, a, b) for a, b in zip(wn, nrm)]
            valid = valid | fb
    return (np.stack(d2k, 1), np.stack(cen, 1) + q, np.stack(nrm, 1),
            valid)


def _gate_margins(x, y, z, q, r2s, r2w, g):
    """Per row, the smallest relative distance of a plain gate value from
    its threshold over the mode's gates (plain float32 arithmetic)."""
    x, y, z, q = (torch.from_numpy(a) for a in (x, y, z, q))
    dx, dy, dz = x - q[:, 0:1], y - q[:, 1:2], z - q[:, 2:3]
    d2 = dx * dx + dy * dy + dz * dz
    d2s = torch.where(d2 <= _F(r2s), d2, torch.tensor(_F(3e38)))
    v = sfm.select_fit_plain(x, y, z, q, r2s, r2w, **g).d2[:, -1:]
    w = ((d2s <= v) & (d2s < 1.5e38)).float()
    _, mean, sec = sfm._moments(w, dx, dy, dz)
    e0, e1, _ = sfm._eig3(*sec)

    def rel(a, b):
        return (a - b).abs() / (a.abs() + b.abs() + 1e-30)

    if g["mode"] == "line":
        return rel(e0, _F(g["eig_ratio"]) * e1).numpy()
    tol = torch.tensor(_F(g["tol"]))
    cf = _F(g["cond_frac"])
    n = sfm._eigvec(*sec, e0, e1)
    m = torch.minimum(rel((sfm._resid(n, mean, dx, dy, dz) * w).max(1).values,
                          tol), rel(e1, cf * e0))
    if g["mode"] == "plane2":
        ww = (d2 <= _F(r2w)).float()
        _, wm, sw = sfm._moments(ww, dx, dy, dz)
        v0, v1, _ = sfm._eig3(*sw)
        rr = sfm._resid(sfm._eigvec(*sw, v0, v1), wm, dx, dy, dz)
        for a in ((rr * ww).max(1).values, (rr * w).max(1).values):
            m = torch.minimum(m, rel(a, tol))
        m = torch.minimum(m, rel(v1, cf * v0))
    return m.numpy()


def _fit_case(seed, N, C, shape="plane"):
    """Candidate slabs around each query (~20% at the 1e9 sentinel), on a
    tilted plane or a line, with duplicated distances (exact ties)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-30, 30, (N, 3)).astype(_F)
    off = rng.uniform(-1.4, 1.4, (N, C, 3)).astype(_F)
    if shape == "plane":
        nv = rng.normal(size=(N, 3)).astype(_F)
        nv /= np.linalg.norm(nv, axis=-1, keepdims=True)
        off -= (off @ nv[..., None]) * nv[:, None, :]
        off += _F(0.02) * rng.normal(size=(N, C, 1)).astype(_F) * nv[:, None]
    else:
        dv = rng.normal(size=(N, 3)).astype(_F)
        dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
        t = rng.uniform(-1, 1, (N, C, 1)).astype(_F)
        off = t * dv[:, None] + _F(0.01) * rng.normal(size=(N, C, 3)).astype(_F)
    off[:, C // 2:C // 2 + C // 4] = off[:, :C // 4]      # exact ties
    cand = (q[:, None, :] + off).astype(_F)
    cand[rng.uniform(size=(N, C)) < 0.2] = _F(1e9)
    cand[:2] = _F(1e9)                                   # nothing in range
    return cand, q


@pytest.mark.parametrize("G,C", [(8, 5), (8, 8), (16, 13), (16, 200),
                                 (32, 40), (32, 200)])
@pytest.mark.parametrize("mode", ["line", "plane", "plane2"])
def test_lane_group_fit_matches_plain_select_fit(G, C, mode):
    cand, q = _fit_case(3 + C, 160, C, "line" if mode == "line" else "plane")
    x, y, z = (np.ascontiguousarray(cand[..., a]) for a in range(3))
    gates = dict(k=5, mode=mode, min_count=5, min_wide=5, eig_ratio=3.0,
                 tol=0.2, cond_frac=0.05)
    r2s, r2w = (1.0, 4.0) if C > 8 else (1e17, 1e17)
    got = _group_fit(x, y, z, q, r2s, r2w, G, **gates)
    want = sfm.select_fit_plain(*(torch.from_numpy(a) for a in (x, y, z, q)),
                                r2s, r2w, **gates)
    np.testing.assert_array_equal(got[0].view(np.uint32),
                                  want.d2.numpy().view(np.uint32))
    wv = want.valid.numpy()
    flips = got[3] != wv
    if flips.any():        # only where a gate sits on its threshold
        m = _gate_margins(x, y, z, q, r2s, r2w, gates)[flips]
        assert m.max() < 1e-5, m
    both = got[3] & wv
    assert both.sum() >= 20
    assert np.abs(got[1] - want.center.numpy())[both].max() < 1e-4
    dots = np.abs((got[2] * want.normal.numpy()).sum(axis=1))[both]
    assert dots.min() > 1 - 1e-4


def test_transposed_butterfly_is_the_lane_tree():
    """The kernel's reduce-scatter (each level halves the values a lane
    carries, then single values combine, then a broadcast) adds every
    value in the same pairwise order as the plain xor butterfly."""
    rng = np.random.default_rng(5)
    for N, G in ((4, 32), (8, 32), (16, 32), (8, 8), (16, 8), (16, 16)):
        v = rng.normal(size=(G, N)).astype(_F)         # lane x value
        carry = [list(v[li]) for li in range(G)]
        idx = [list(range(N)) for _ in range(G)]
        o = 1
        while len(carry[0]) > 1 and o < G:
            h = len(carry[0]) // 2
            new_c, new_i = [], []
            for li in range(G):
                up = bool(li & o)
                keep = slice(h, 2 * h) if up else slice(0, h)
                part = li ^ o
                new_c.append([a + b for a, b in zip(carry[li][keep],
                                                    carry[part][keep])])
                new_i.append(idx[li][keep])
            carry, idx, o = new_c, new_i, 2 * o
        while o < G:
            carry = [[a + b for a, b in zip(carry[li], carry[li ^ o])]
                     for li in range(G)]
            o *= 2
        got = np.zeros(N, _F)
        for li in range(G):
            for val, m in zip(carry[li], idx[li]):
                got[m] = val
        want = np.array([_lane_tree(v[:, m][None, :])[0] for m in range(N)])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("G,threads", [(8, 128), (16, 128), (32, 256)])
def test_pair_launch_routes_every_query_to_its_problem(G, threads):
    """Blocks of threads / G queries: the queries of the problem with more
    work (N C) fill the first blocks, the other's follow; a block serves
    one problem, a dead group only pads the last block of a problem."""
    qb = threads // G
    for na, ca, nb, cb in ((1, 8, 1, 8), (1024, 256, 4096, 256),
                           (1024, 256, 33, 8), (0, 8, 50, 8), (50, 8, 0, 8)):
        first = 1 if nb * cb > na * ca else 0
        ns = (na, nb)
        blocks0 = -(-ns[first] // qb)
        blocks = blocks0 + -(-ns[1 - first] // qb)
        seen = {0: [], 1: []}
        for blk in range(blocks):
            later = blk >= blocks0
            which = 1 - first if later else first
            n0 = (blk - (blocks0 if later else 0)) * qb
            live = [n0 + g for g in range(qb) if n0 + g < ns[which]]
            assert live, (na, nb, blk)
            if len(live) < qb:
                assert blk == (blocks - 1 if later else blocks0 - 1)
            seen[which] += live
        assert seen[0] == list(range(na)) and seen[1] == list(range(nb))


@pytest.mark.parametrize("layout", ["rows", "planar"])
@pytest.mark.parametrize("mode_b", ["line", "plane", "plane2"])
def test_select_fit_pair_equals_two_calls_on_cpu(layout, mode_b):
    ca, qa = _fit_case(1, 37, 24, "line")
    cb, qb = _fit_case(2, 53, 40)

    def lay(c):
        if layout == "rows":
            t = np.transpose(c, (0, 2, 1)).reshape(c.shape[0], -1)
        else:
            t = np.transpose(c, (2, 0, 1))
        return torch.from_numpy(np.ascontiguousarray(t))

    kw_a = dict(k=5, mode="line", min_count=5, eig_ratio=3.0)
    kw_b = dict(k=5, mode=mode_b, min_count=5, min_wide=5, tol=0.2)
    args_a = (lay(ca), torch.from_numpy(qa), 1.0, 4.0)
    args_b = (lay(cb), torch.from_numpy(qb), 0.5, 2.0)
    pair = sfm.select_fit_pair(*args_a, kw_a, *args_b, kw_b)
    one = (sfm.select_fit(*args_a, **kw_a), sfm.select_fit(*args_b, **kw_b))
    for got, want in zip(pair, one):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert pair[1].valid.any()


# -------------------------------------------------------------------- knn
_KINF = _F(3e38)
_SAMPLE, _CHUNK, _WARPS_K = 64, 32, 4


def _insert(bd, bi, rows, d, idx):
    """The kernel's strict insertion into sorted lists, rows where the
    caller found d below the last entry."""
    KT = bd.shape[1]
    bd[rows, KT - 1] = d
    bi[rows, KT - 1] = idx
    for t in range(KT - 1, 0, -1):
        sw = rows[bd[rows, t] < bd[rows, t - 1]]
        bd[sw, t], bd[sw, t - 1] = bd[sw, t - 1].copy(), bd[sw, t].copy()
        bi[sw, t], bi[sw, t - 1] = bi[sw, t - 1].copy(), bi[sw, t].copy()


def _fma(a, b, c):
    """float32 multiply-add with one rounding (the float64 product of two
    float32 is exact)."""
    return (a.astype(np.float64) * b + c).astype(_F)


_SHIFT, _WIDE, _FLT_MIN = _F(1 - 2.0 ** -19), _F(1 + 2.0 ** -20), _F(2.0 ** -126)


def _filter(q, r, ok, thr):
    """csrc/knn.cu's chunk filter: f = W - 2 q.r in three multiply-adds
    (W = |r|^2 (1 - 2^-19), staged), passing where not f > F(thr, s)."""
    w = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + r[:, 2] * r[:, 2]) * _SHIFT
    w = np.where(ok, np.where(np.isfinite(w), w, _F(-np.inf)), _F(np.inf))
    rr = np.where(ok[:, None], r, _F(0))
    a = _F(-2) * q
    f = _fma(a[:, 2:3], rr[None, :, 2], _fma(a[:, 1:2], rr[None, :, 1],
             _fma(a[:, 0:1], rr[None, :, 0], w[None, :])))
    s = (q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]) * _SHIFT
    t = thr * _WIDE
    F = (t - s) + _F(2.0 ** -20) * (t + s) + _FLT_MIN
    with np.errstate(invalid="ignore"):
        return ~(f > F[:, None])


def _scan_segment(q, refs, ok, lo, hi, k, bd, bi):
    """One warp's scan of refs [lo, hi) in chunks of 32: the filter against
    the k-th distance as it stood before the chunk, then each hit's exact
    d2 through the strict insertion, in index order."""
    for j0 in range(lo, hi, _CHUNK):
        j1 = min(hi, j0 + _CHUNK)
        r = refs[j0:j1]
        diff = q[:, None, :] - r[None, :, :]
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        d = d + diff[..., 2] * diff[..., 2]
        d = np.where(ok[None, j0:j1], d, _F(np.inf))
        hit = _filter(q, r, ok[j0:j1], bd[:, -1]) & ok[None, j0:j1]
        assert not (~hit & (d < bd[:, -1:])).any()     # never drops one
        for u in np.flatnonzero(hit.any(axis=0)):
            rows = np.flatnonzero(hit[:, u] & (d[:, u] < bd[:, -1]))
            if rows.size:
                _insert(bd, bi, rows, d[rows, u], j0 + u)


def _merge_from(bd, bi, od, oi):
    """Insert a later (higher-index) sorted list, stopping at the first
    entry not below the last."""
    for t in range(od.shape[1]):
        rows = np.flatnonzero(od[:, t] < bd[:, -1])
        if rows.size:
            _insert(bd, bi, rows, od[rows, t], oi[rows, t])


def _merge_cluster(lists, ranks):
    """Warps 1 -> 0, 3 -> 2, 2 -> 0 in each block, then rank r + s into
    rank r for s = 1, 2, 4, ..."""
    blocks = []
    for b in range(ranks):
        w = lists[b * _WARPS_K:(b + 1) * _WARPS_K]
        _merge_from(*w[0], *w[1])
        _merge_from(*w[2], *w[3])
        _merge_from(*w[0], *w[2])
        blocks.append(w[0])
    s = 1
    while s < ranks:
        for b in range(0, ranks, 2 * s):
            if b + s < ranks:
                _merge_from(*blocks[b], *blocks[b + s])
        s *= 2
    return blocks[0]


def _cluster_knn(q, refs, mask, k, ranks, R):
    """csrc/knn.cu's two phases over ranks x 4 warp segments, with tiles of
    32 R queries (the ragged tile padded)."""
    Q, M = q.shape[0], refs.shape[0]
    tile = 32 * R
    qp = np.zeros((-(-Q // tile) * tile, 3), _F)
    qp[:Q] = q
    per = -(-M // (ranks * _WARPS_K))
    seg = max(4, -(-per // 4) * 4)
    segs = [(s * seg, min(M, s * seg + seg)) for s in range(ranks * _WARPS_K)]

    def run(init_d, lengths):
        lists = []
        for (lo, hi), n in zip(segs, lengths):
            bd = np.repeat(init_d[:, None], k, axis=1).astype(_F)
            bi = np.full(bd.shape, -1, np.int64)
            _scan_segment(qp, refs, mask, lo, lo + max(0, n), k, bd, bi)
            lists.append((bd, bi))
        return _merge_cluster(lists, ranks)

    bd, _ = run(np.full(len(qp), _KINF, _F),
                [min(_SAMPLE, hi - lo) for lo, hi in segs])
    T = bd[:, -1]
    Tp = np.where(T < _KINF, np.nextafter(T, _F(np.inf)), _KINF).astype(_F)
    bd, bi = run(Tp, [hi - lo for lo, hi in segs])
    empty = (bi < 0) | (bd >= _F(1.5e38))
    return (np.where(empty, _KINF, bd)[:Q],
            np.where(empty, -1, bi)[:Q].astype(np.int32))


def _knn_case(name, rng, Q, M, ranks):
    q = rng.uniform(-3, 3, (Q, 3)).astype(_F)
    r = rng.uniform(-3, 3, (M, 3)).astype(_F)
    mask = rng.uniform(size=M) >= 0.1
    per = -(-M // (ranks * _WARPS_K))
    seg = max(4, -(-per // 4) * 4)
    for cut in (seg, 4 * seg, 5 * seg):     # equal distances across edges
        if cut + 3 < M:
            r[cut - 2:cut + 2] = r[cut - 2]
            mask[cut - 2:cut + 2] = True
            q[cut % Q] = r[cut - 2] + _F(0.01)
    if 3 * seg < M:
        mask[2 * seg:3 * seg] = False       # an all-masked segment
    if name == "few_valid":
        mask[:] = False
        mask[[3, M // 2, M - 1]] = True
    return q, r, mask


@pytest.mark.parametrize("k", [1, 5, 8, 16])
@pytest.mark.parametrize("name,Q,M,ranks", [("ties", 70, 1001, 2),
                                            ("ties", 45, 901, 16),
                                            ("few_valid", 40, 700, 2)])
def test_cluster_two_phase_knn_matches_plain(k, name, Q, M, ranks):
    rng = np.random.default_rng(k + M)
    q, r, mask = _knn_case(name, rng, Q, M, ranks)
    _, _, R, _ = launch_plan(Q, M)
    got_d, got_i = _cluster_knn(q, r, mask, k, ranks, R)
    want_d, want_i = knn_plain(*(torch.from_numpy(a) for a in (q, r, mask)),
                               k)
    np.testing.assert_array_equal(got_d.view(np.uint32),
                                  want_d.numpy().view(np.uint32))
    np.testing.assert_array_equal(got_i, want_i.numpy())
    if name == "few_valid" and k > 3:
        assert (got_i[:, 3:] == -1).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0, 1e6])
def test_knn_filter_never_drops_a_ref_the_exact_test_keeps(scale):
    """Near-duplicates, far-from-origin clouds and subnormal distances: the
    multiply-add filter passes every ref whose exact d2 is at most the
    threshold, with the threshold at that d2 itself."""
    rng = np.random.default_rng(int(scale * 10))
    off = _F(scale) * rng.uniform(-50, 50, 3).astype(_F)
    q = (off + _F(scale) * rng.uniform(-1, 1, (64, 3))).astype(_F)
    r = (off + _F(scale) * rng.uniform(-1, 1, (256, 3))).astype(_F)
    r[:64] = q + _F(scale * 1e-6) * rng.normal(size=(64, 3)).astype(_F)
    r[64] = q[0]
    r[65] = q[1] + _F(1e-30)
    diff = q[:, None, :] - r[None, :, :]
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    d = d + diff[..., 2] * diff[..., 2]
    ok = np.ones(256, bool)
    for j in range(256):
        assert _filter(q, r, ok, d[:, j])[:, j].all(), j
