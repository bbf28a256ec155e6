"""The decompositions of the hand-written kernels, held to the plain
versions on the CPU.

``csrc/pick_rounds.cu`` does not run the pick rounds as iterated argmaxes:
it sorts each sector's valid columns once per score plane as 64-bit keys,
stores the runs in sector order and walks them from a per-sector cursor
with 32-wide ballots, finding dominating picks through a column -> pick
map.
``csrc/odo_corr.cu`` splits the reference cloud into slices over the
blocks of a thread-block cluster, scans each slice in 8 warp segments and
merges the minima in index order. The numpy mirrors below do exactly
those steps, so the CPU suite checks the decompositions themselves, on
seeded adversarial inputs, against ``pick_rounds_plain`` and
``odo_corr_plain`` (which the JAX package's kernels hold in
``test_torch_features.py`` and ``test_torch_odometry.py``).
"""

import numpy as np
import pytest
import torch

from msf_loam_tpu_torch.ops.odo_corr import odo_corr_plain, ref_planes
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
