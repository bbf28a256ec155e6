"""The port's pose graph (``msf_loam_tpu_torch.slam.posegraph``) and its
block-Thomas kernel's plain version, against the JAX package's
``slam/posegraph.py`` on the same numpy-seeded inputs, plus the JAX
pose-graph tests' scenarios on the port alone at their own bounds.

One JAX compile in this file: a single jitted program holds every JAX
result compared here, ``optimize_with_loops`` at N = 24 with 2 loops
padded to 4, GPS ties on, 3 iterations, among them.

``csrc/block_tridiag.cu`` solves in segments: each thread block condenses
one segment's interior onto its end blocks one right-hand-side column a
thread (every thread factorising the 6x6 itself), block 0 runs the
separator's block-Thomas, and each column back-substitutes its segment
alone. ``_mirror`` below does exactly that in numpy float32, and is held
bit for bit to ``block_tridiag_plain`` (which runs every segment's step
at once, as batched tensor operations) on adversarial blocks with segment
ends placed across them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import PoseGraphConfig as JCfg
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.slam import posegraph as jpg
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import PoseGraphConfig
from msf_loam_tpu_torch.core.se3 import Pose, quat_exp, quat_multiply
from msf_loam_tpu_torch.ops.block_tridiag import block_tridiag_plain, segments
from msf_loam_tpu_torch.slam import posegraph

torch.set_num_threads(1)
CFG = PoseGraphConfig()
RNG = np.random.default_rng(17)


def npy(x):
    return jax.tree.map(np.asarray, x)


def tp(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _random_tridiag(rng, N, diag=6.0, scale=0.3):
    D = rng.normal(size=(N, 6, 6))
    D = np.einsum("nij,nkj->nik", D, D) + diag * np.eye(6)
    U = rng.normal(size=(N - 1, 6, 6)) * scale
    return D.astype(np.float32), U.astype(np.float32)


def _dense(D, U):
    N = D.shape[0]
    H = np.zeros((6 * N, 6 * N))
    for i in range(N):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
    for i in range(N - 1):
        H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
        H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    return H


def _random_poses(rng, n):
    q = rng.normal(size=(n, 4))
    return (rng.normal(size=(n, 3)).astype(np.float32),
            (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))


# ------------------------------------------------------------ against JAX
def _square_problem(N, drift, rng, gps_period):
    """A square driven with a compounding yaw bias in the odometry (as the
    JAX loop-closure tests build it), GPS fixes with U(-5, 5) cm noise
    every ``gps_period`` poses. Returns numpy (gt_t, gt_q, (t0, q0) the
    drifted start, (rel_t, rel_q) the biased measurements, (gps pose
    indices as times, gps_xyz))."""
    side = max(1, N // 4)
    gt_t, yaws = [np.zeros(3)], [0.0]
    for i in range(1, N):
        h = (i // side) * (np.pi / 2)
        gt_t.append(gt_t[-1] + np.array([np.cos(h), np.sin(h), 0.0]))
        yaws.append(h)
    gt_t, yaws = np.stack(gt_t), np.asarray(yaws)

    def yaw_q(y):
        return np.stack([np.cos(y / 2), 0 * y, 0 * y, np.sin(y / 2)], 1)
    dyaw = np.diff(yaws) + drift
    step = np.diff(gt_t, axis=0)
    c, s = np.cos(yaws[:-1]), np.sin(yaws[:-1])
    rel_t = np.stack([c * step[:, 0] + s * step[:, 1],
                      -s * step[:, 0] + c * step[:, 1], 0 * c], 1)
    p, ys = [np.zeros(3)], [0.0]
    for i in range(N - 1):
        c, s = np.cos(ys[-1]), np.sin(ys[-1])
        p.append(p[-1] + np.array([c * rel_t[i, 0] - s * rel_t[i, 1],
                                   s * rel_t[i, 0] + c * rel_t[i, 1], 0.0]))
        ys.append(ys[-1] + dyaw[i])
    gi = np.arange(0, N, gps_period)
    gxyz = gt_t[gi] + rng.uniform(-0.05, 0.05, (len(gi), 3))
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(gt_t), f32(yaw_q(yaws)), (f32(np.stack(p)),
            f32(yaw_q(np.asarray(ys)))), (f32(rel_t), f32(yaw_q(dyaw))),
            (f32(gi), f32(gxyz)))


def _cases():
    """Every numpy input this file hands to both packages."""
    rng = np.random.default_rng(3)
    n = 7
    fac = dict(pi=_random_poses(rng, n), pj=_random_poses(rng, n),
               meas=_random_poses(rng, n),
               di=(rng.normal(size=(n, 6)) * 0.05).astype(np.float32),
               dj=(rng.normal(size=(n, 6)) * 0.05).astype(np.float32),
               gps=rng.normal(size=(n, 3)).astype(np.float32),
               frac=rng.uniform(0, 1, n).astype(np.float32))
    rng = np.random.default_rng(5)
    times = np.cumsum(rng.uniform(0.5, 1.5, 12)).astype(np.float32)
    gps_t = np.concatenate([[times[0] - 1.0], times[[2, 5]],
                            rng.uniform(times[0], times[-1], 6),
                            [times[-1] + 0.5]]).astype(np.float32)
    gps_valid = np.ones(len(gps_t), bool)
    gps_valid[3] = False
    graph = dict(times=times, poses=_random_poses(rng, 12), gps_t=gps_t,
                 gps_xyz=rng.normal(size=(len(gps_t), 3)).astype(np.float32),
                 gps_valid=gps_valid)
    tri = {}
    for N, m in ((20, 1), (12, 9)):
        D, U = _random_tridiag(RNG, N)
        tri[m] = (D, U, RNG.normal(size=(N, 6, m)).astype(np.float32))
    rng = np.random.default_rng(23)
    N, L = 10, 3
    D, U = _random_tridiag(rng, N, diag=8.0)
    W = np.zeros((N, 6, 6 * L), np.float32)
    for l, (i, j) in enumerate([(0, 7), (2, 9), (1, 5)]):
        W[i, :, 6 * l:6 * l + 6] = rng.normal(size=(6, 6)) * 0.5
        W[j, :, 6 * l:6 * l + 6] = rng.normal(size=(6, 6)) * 0.5
    wood = (D, U, W, rng.normal(size=(N, 6)).astype(np.float32))
    # the GN problem: 24 poses, GPS every 4th, 2 loops padded to 4
    N = 24
    gt_t, gt_q, (t0, q0), (rt, rq), (g_times, gxyz) = \
        _square_problem(N, 0.02, np.random.default_rng(11), 4)
    ri, rj = np.array([0, 2]), np.array([N - 1, 20])
    gt = Pose(tp(gt_t), tp(gt_q))
    meas = Pose(gt.t[ri], gt.q[ri]).inverse().compose(
        Pose(gt.t[rj], gt.q[rj]))
    data = posegraph.build_graph_data(
        torch.arange(N, dtype=torch.float32), Pose(tp(t0), tp(q0)),
        tp(g_times), tp(gxyz), torch.ones(len(g_times), dtype=torch.bool))
    data = data._replace(rel_meas=Pose(tp(rt), tp(rq)))
    loops = posegraph.LoopFactors.pad(ri, rj, meas, to_l=4)
    opt = dict(poses=(t0, q0), data=interop.to_numpy(data),
               loops=interop.to_numpy(loops))
    return dict(fac=fac, graph=graph, tri=tri, wood=wood, opt=opt)


def _jax_program(c):
    """The JAX package's side of every comparison, as one program."""
    P = lambda tq: JPose(*tq)
    f = c["fac"]
    jv, jjac, gv, gjac = jpg._make_factor_fns(JCfg())
    rel_args = (f["di"], f["dj"], P(f["pi"]), P(f["pj"]), P(f["meas"]))
    gps_args = rel_args[:4] + (f["gps"], f["frac"])
    g = c["graph"]
    o = c["opt"]
    d = o["data"]
    data = jpg.PoseGraphData(
        times=d["times"], rel_meas=JPose(d["rel_meas"]["t"],
                                         d["rel_meas"]["q"]),
        rel_valid=d["rel_valid"], gps_xyz=d["gps_xyz"], gps_seg=d["gps_seg"],
        gps_frac=d["gps_frac"], gps_valid=d["gps_valid"])
    lo = o["loops"]
    loops = jpg.LoopFactors(idx_i=lo["idx_i"], idx_j=lo["idx_j"],
                            meas=JPose(lo["meas"]["t"], lo["meas"]["q"]),
                            valid=lo["valid"])
    D1, U1, B1 = c["tri"][1]
    D9, U9, B9 = c["tri"][9]
    return dict(
        rel=(jv(*rel_args), jjac(*rel_args)),
        gps=(gv(*gps_args), gjac(*gps_args)),
        graph=jpg.build_graph_data(g["times"], P(g["poses"]), g["gps_t"],
                                   g["gps_xyz"], g["gps_valid"]),
        tri1=jpg.solve_block_tridiag(D1, U1, B1[..., 0])[..., None],
        tri9=jpg.solve_block_tridiag_multi(D9, U9, B9),
        wood=jpg._woodbury_solve(*c["wood"][:2], c["wood"][3], c["wood"][2]),
        opt=jpg.optimize_with_loops(P(o["poses"]), data, loops, JCfg(),
                                    n_iters=3))


@pytest.fixture(scope="module")
def ref():
    """(numpy inputs, JAX results). The JAX side is one jitted program,
    compiled once with XLA's LLVM backend at optimisation level 0 and its
    expensive passes off (the HLO passes, which decide how XLA rounds, are
    unchanged), which keeps it to a few seconds on one core."""
    cases = _cases()
    c = jax.tree.map(lambda a: jnp.asarray(a) if isinstance(
        a, np.ndarray) else a, cases)
    exe = jax.jit(_jax_program).lower(c).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return cases, npy(exe(c))


def _check_factors(ref):
    """Values and exact Jacobians (torch.func.jacrev under vmap against
    jax.jacrev under vmap) of the relative-pose and GPS factors, at nonzero
    deltas. Tolerance 2e-4 of each quantity's scale: the residuals carry
    1/0.01 and 1/0.1 weights, and the two frameworks round the quaternion
    chain in different orders."""
    cases, want = ref
    f = cases["fac"]
    P = lambda tq: Pose(tp(tq[0]), tp(tq[1]))
    rel_args = (tp(f["di"]), tp(f["dj"]), P(f["pi"]), P(f["pj"]),
                P(f["meas"]))
    gps_args = rel_args[:4] + (tp(f["gps"]), tp(f["frac"]))
    rel_val, rel_lin, gps_val, gps_lin = posegraph._make_factor_fns(CFG)
    for key, val, lin, args in (("rel", rel_val, rel_lin, rel_args),
                                ("gps", gps_val, gps_lin, gps_args)):
        r_want, (Ji_want, Jj_want) = want[key]
        r, Ji, Jj = lin(*args)
        for got, w in ((val(*args), r_want), (r, r_want), (Ji, Ji_want),
                       (Jj, Jj_want)):
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=2e-4 * np.abs(w).max())


def _check_graph_data(ref):
    """Relative measurements, GPS bracketing (searchsorted right) and
    interpolation, with fixes outside the keyframe times invalidated."""
    cases, want = ref
    g, w = cases["graph"], want["graph"]
    got = interop.to_numpy(posegraph.build_graph_data(
        tp(g["times"]), Pose(tp(g["poses"][0]), tp(g["poses"][1])),
        tp(g["gps_t"]), tp(g["gps_xyz"]), torch.as_tensor(g["gps_valid"])))
    np.testing.assert_array_equal(got["gps_seg"], w.gps_seg)
    np.testing.assert_array_equal(got["gps_valid"], w.gps_valid)
    np.testing.assert_array_equal(got["rel_valid"], w.rel_valid)
    np.testing.assert_allclose(got["gps_frac"], w.gps_frac, atol=1e-6)
    np.testing.assert_allclose(got["rel_meas"]["t"], w.rel_meas.t, atol=1e-5)
    np.testing.assert_allclose(got["rel_meas"]["q"], w.rel_meas.q, atol=1e-6)


def _check_block_tridiag(ref, m):
    """The plain version (the kernel's arithmetic) against JAX's
    lax.scan solves (LAPACK LU, reciprocal pivots) and a float64 dense
    solve, N = 20 with one right-hand side and N = 12 with nine. Both
    float32 solvers sit within 1e-5 of the float64 answer on these
    well-conditioned systems (D = GGᵀ + 6I, U 0.3-scaled), so they are
    held to each other at 2e-5."""
    cases, want = ref
    D, U, B = cases["tri"][m]
    N = D.shape[0]
    if m == 1:
        got = posegraph.solve_block_tridiag(tp(D), tp(U), tp(B[..., 0]))
        got = got[..., None].numpy()
    else:
        got = posegraph.solve_block_tridiag_multi(tp(D), tp(U), tp(B)).numpy()
    w = want[f"tri{m}"]
    dense = np.linalg.solve(_dense(D, U), B.reshape(6 * N, m).astype(
        np.float64)).reshape(N, 6, m)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(w, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, w, atol=2e-5, rtol=0)


def _check_woodbury(ref):
    """(T + W Wᵀ)⁻¹ b: the port's one-launch [rhs | W] solve plus the
    capacitance correction against JAX's two scans plus its correction
    (``_woodbury_solve``) and a float64 dense solve."""
    cases, want = ref
    D, U, W, b = cases["wood"]
    N, m = W.shape[0], W.shape[2]
    got = posegraph._woodbury_solve(tp(D), tp(U), tp(b), tp(W)).numpy()
    Wf = W.reshape(6 * N, m).astype(np.float64)
    dense = np.linalg.solve(_dense(D, U) + Wf @ Wf.T,
                            b.reshape(-1)).reshape(N, 6)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want["wood"], atol=1e-5, rtol=0)


def test_optimize_with_loops_matches_jax(ref):
    """The compiled JAX pose-graph solve: chain + GPS (every 4th pose) + 2
    loops padded to L=4, 3 GN iterations from a drifted start, the same
    numpy problem through both packages. Poses within 1e-4 m / 1e-4 (the
    bound JAX's own test_invalid_loops_match_plain_optimize holds between
    two of its solvers), costs within 1e-4 relative."""
    cases, want = ref
    o = cases["opt"]
    w = want["opt"]
    got = posegraph.optimize_with_loops(
        Pose(tp(o["poses"][0]), tp(o["poses"][1])),
        interop.pose_graph_data_from_numpy(
            posegraph.PoseGraphData(
                **{k: v for k, v in o["data"].items() if k != "rel_meas"},
                rel_meas=Pose(**o["data"]["rel_meas"])), "cpu"),
        interop.loop_factors_from_numpy(posegraph.LoopFactors(
            **{k: v for k, v in o["loops"].items() if k != "meas"},
            meas=Pose(**o["loops"]["meas"])), "cpu"), CFG, n_iters=3)
    np.testing.assert_allclose(got.poses.t.numpy(), w.poses.t, atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(got.poses.q.numpy(), w.poses.q, atol=1e-4,
                               rtol=0)
    for g, x in ((got.initial_cost, w.initial_cost),
                 (got.final_cost, w.final_cost)):
        np.testing.assert_allclose(float(g), float(x), rtol=1e-4)
    assert float(got.final_cost) < float(got.initial_cost)


# --------------------------------------------- the kernel's decomposition
def _mirror(D, U, B, seg_len=None):
    """numpy float32 mirror of csrc/block_tridiag.cu: each 6x6 factorised
    in place with selected row swaps (pivot by a tree of pairwise picks) and
    its multipliers in step order; each segment condensed one right-hand
    side column ("thread") at a time; the separator's block-Thomas; each
    interior column back-substituted alone."""
    f32 = np.float32
    N, m = B.shape[0], B.shape[2]
    L, P = segments(N, seg_len)

    def better(v, best):
        return not np.isnan(best) and (np.isnan(v) or v > best)

    def factor(A):
        a, p = A.astype(f32).copy(), [0] * 6
        for k in range(6):
            bv, bx = [abs(a[i, k]) for i in range(k, 6)], list(range(k, 6))
            for w in (1, 2, 4):
                for i in range(0, 6 - w, 2 * w):
                    if i + w < 6 - k and better(bv[i + w], bv[i]):
                        bv[i], bx[i] = bv[i + w], bx[i + w]
            bi = p[k] = bx[0]
            a[[k, bi], k:] = a[[bi, k], k:]
            for i in range(k + 1, 6):
                f = a[i, k] / a[k, k]
                a[i, k] = f
                for j in range(k + 1, 6):
                    a[i, j] = a[i, j] - f * a[k, j]
        return a, p

    def apply(fac, y):
        a, p = fac
        y = [f32(v) for v in y]
        for k in range(6):
            y[k], y[p[k]] = y[p[k]], y[k]
            for i in range(k + 1, 6):
                y[i] = y[i] - a[i, k] * y[k]
        for k in range(5, -1, -1):
            y[k] = y[k] / a[k, k]
            for i in range(k):
                y[i] = y[i] - a[i, k] * y[k]
        return np.array(y, f32)

    def mv(M, z):                    # M z, k = 0..5 in order
        out = []
        for r in range(6):
            acc = M[r, 0] * z[0]
            for k in range(1, 6):
                acc = acc + M[r, k] * z[k]
            out.append(acc)
        return np.array(out, f32)

    def mtv(M, z):                   # Mᵀ z
        return mv(np.ascontiguousarray(M.T), z)

    seg = [(s * L, L if s < P - 1 else N - (P - 1) * L) for s in range(P)]
    Dg, Ug, Bg, res = [], [], [], []
    for s, (st, ln) in enumerate(seg):          # condense
        if ln == 1:
            Dg, Bg = [D[0].copy()], [B[0].copy()]
            break
        S00, S0k, Skk = D[st].copy(), U[st].copy(), D[st + 1].copy()
        b0, bk = B[st].copy(), B[st + 1].copy()
        steps = []
        for k in range(1, ln - 1):
            g = st + k
            fac = factor(Skk)
            steps.append((fac, S0k.copy(), bk.copy()))
            S0k_n, Skk_n = np.empty_like(S0k), np.empty_like(Skk)
            for j in range(12 + m):
                z = S0k[j] if j < 6 else U[g][:, j - 6] if j < 12 \
                    else bk[:, j - 12]
                z = apply(fac, z)
                t = mv(S0k, z)
                if j < 6:
                    S00[:, j] = S00[:, j] - t
                    continue
                if j < 12:
                    S0k_n[:, j - 6] = -t
                else:
                    b0[:, j - 12] = b0[:, j - 12] - t
                t = mtv(U[g], z)
                if j < 12:
                    Skk_n[:, j - 6] = D[g + 1][:, j - 6] - t
                else:
                    bk[:, j - 12] = B[g + 1][:, j - 12] - t
            S0k, Skk = S0k_n, Skk_n
        res.append(steps)
        Dg += [S00, Skk]
        Bg += [b0, bk]
        Ug += [S0k] + ([U[st + ln - 1]] if s < P - 1 else [])
    n = len(Dg)                                  # separator: block-Thomas
    dt, bts, facs = Dg[0], [Bg[0].copy()], []
    for i in range(1, n):
        fac = factor(dt)
        facs.append(fac)
        Y = np.stack([apply(fac, Ug[i - 1][:, j]) for j in range(6)], 1)
        dt_n, bt_n = np.empty_like(dt), np.empty_like(Bg[i])
        for j in range(6 + m):
            col = Ug[i - 1][:, j] if j < 6 else bts[-1][:, j - 6]
            t = mtv(Y, col)
            if j < 6:
                dt_n[:, j] = Dg[i][:, j] - t
            else:
                bt_n[:, j - 6] = Bg[i][:, j - 6] - t
        dt = dt_n
        bts.append(bt_n)
    facs.append(factor(dt))
    xg = np.zeros((n, 6, m), f32)
    for c in range(m):
        x = apply(facs[n - 1], bts[n - 1][:, c])
        xg[n - 1, :, c] = x
        for i in range(n - 2, -1, -1):
            x = apply(facs[i], bts[i][:, c] - mv(Ug[i], x))
            xg[i, :, c] = x
    X = np.zeros_like(B)
    for s, (st, ln) in enumerate(seg):          # back-substitute
        X[st] = xg[min(2 * s, n - 1)]
        X[st + ln - 1] = xg[min(2 * s + 1, n - 1)]
        for c in range(m):
            x0, x = X[st][:, c], X[st + ln - 1][:, c]
            for k in range(ln - 2, 0, -1):
                fac, S0k, bk = res[s][k - 1]
                y = bk[:, c] - mtv(S0k, x0)
                y = y - mv(U[st + k], x)
                x = apply(fac, y)
                X[st + k, :, c] = x
    return X


def _adversarial_blocks(rng, N, case):
    D, U = _random_tridiag(rng, N)
    if case == "ties":
        # equal |entries| down each pivot column (signs differ): the
        # first maximal one must win
        v = np.float32(3.0)
        for n in range(0, N, 2):
            D[n][:, 0] = v * np.array([1, -1, 1, -1, 1, 1], np.float32)
            D[n][0, :] = D[n][:, 0]
    elif case == "zero_pivot":
        # a zero leading entry forces a swap at step 0, a tiny one later
        for n in range(N):
            D[n][0, 0] = 0.0
            D[n][2, 2] = np.float32(1e-7)
    return D, U


def _check_mirror(case):
    """N = 9 under the rule (segments 4 + 5) and with segments of 2 (the
    last of 3) and of 3: the tied and zero pivots of even blocks fall on
    segment ends, interiors and separator blocks alike."""
    rng = np.random.default_rng({"random": 1, "ties": 2, "zero_pivot": 3}[case])
    N, m = 9, 4
    D, U = _adversarial_blocks(rng, N, case)
    B = rng.normal(size=(N, 6, m)).astype(np.float32)
    for seg_len in (None, 2, 3):
        want = block_tridiag_plain(tp(D), tp(U), tp(B), seg_len).numpy()
        got = _mirror(D, U, B, seg_len)
        assert np.isfinite(want).all()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _check_columns_independent():
    """[rhs | W] in one solve equals the two groups solved apart, bit for
    bit (the Woodbury solve's one launch)."""
    D, U = _random_tridiag(RNG, 7)
    B = RNG.normal(size=(7, 6, 5)).astype(np.float32)
    both = block_tridiag_plain(tp(D), tp(U), tp(B)).numpy()
    one = block_tridiag_plain(tp(D), tp(U), tp(B[..., :1])).numpy()
    rest = block_tridiag_plain(tp(D), tp(U), tp(B[..., 1:])).numpy()
    np.testing.assert_array_equal(both, np.concatenate([one, rest], -1))


# ------------------------------------------- the JAX scenarios, port alone
def _trajectory(n, drift=0.0):
    """tests/test_posegraph.py's circle-ish trajectory and its drifted
    odometry version (port Poses on the CPU)."""
    ts = np.arange(n) * 1.0
    gt_t = np.stack([0.5 * ts, 2 * np.sin(0.1 * ts), 0 * ts], axis=1)
    yaw = 0.05 * ts
    gt_q = np.stack([np.cos(yaw / 2), 0 * ts, 0 * ts, np.sin(yaw / 2)], 1)
    gt = Pose(tp(gt_t), tp(gt_q))
    if drift == 0.0:
        return ts, gt, gt
    est = [Pose(gt.t[0], gt.q[0])]
    for i in range(1, n):
        rel = Pose(gt.t[i - 1], gt.q[i - 1]).inverse().compose(
            Pose(gt.t[i], gt.q[i]))
        est.append(est[-1].compose(
            Pose(rel.t + torch.tensor([drift, 0.0, 0.0]), rel.q)))
    return ts, gt, Pose(torch.stack([p.t for p in est]),
                        torch.stack([p.q for p in est]))


def _data(ts, poses, gps_t, gps_xyz):
    return posegraph.build_graph_data(
        tp(ts), poses, tp(gps_t), tp(gps_xyz),
        torch.ones(len(gps_t), dtype=torch.bool))


def _check_gps_drift():
    ts, gt, est = _trajectory(40, drift=0.02)
    data = _data(ts, est, ts[::5], gt.t[::5])
    out = posegraph.optimize(est, data, CFG, n_iters=10)
    before = (est.t - gt.t).norm(dim=1).max()
    after = (out.poses.t - gt.t).norm(dim=1).max()
    assert before > 0.3
    assert after < 0.08, f"after={after}"
    assert float(out.final_cost) < float(out.initial_cost)


def _check_sim_gps():
    """1 Hz fixes with U(-5, 5) cm noise."""
    ts, gt, est = _trajectory(60, drift=0.015)
    gps_xyz = gt.t.numpy()[::10] + RNG.uniform(-0.05, 0.05, size=(6, 3))
    out = posegraph.optimize(est, _data(ts, est, ts[::10], gps_xyz), CFG,
                             n_iters=10)
    assert float((out.poses.t - gt.t).norm(dim=1).mean()) < 0.1


def _check_interpolated_gps():
    n = 10
    ts = np.arange(n) * 1.0
    gt = Pose(tp(np.stack([ts, 0 * ts, 0 * ts], 1)),
              Pose.identity(batch_shape=(n,)).q)
    data = _data(ts, gt, [2.5, 6.5], [[2.5, 0.5, 0], [6.5, 0.5, 0]])
    np.testing.assert_allclose(data.gps_frac.numpy(), [0.5, 0.5], atol=1e-6)
    np.testing.assert_array_equal(data.gps_seg.numpy(), [2, 6])
    out = posegraph.optimize(gt, data, CFG, n_iters=5)
    assert float(out.poses.t[:, 1].max()) > 0.05


def _check_no_gps_noop():
    ts, gt, _ = _trajectory(15)
    data = _data(ts, gt, np.zeros(0), np.zeros((0, 3)))
    out = posegraph.optimize(gt, data, CFG, n_iters=5)
    np.testing.assert_allclose(out.poses.t.numpy(), gt.t.numpy(), atol=1e-4)


def _check_padded_graph():
    n = 25
    ts, gt, est = _trajectory(n, drift=0.02)
    data = _data(ts, est, ts[::5], gt.t[::5])
    plain = posegraph.optimize(est, data, CFG, n_iters=8)
    poses_p, data_p = posegraph.pad_graph(est, data,
                                          posegraph.next_bucket(n))
    assert poses_p.t.shape[0] == 64
    pad = posegraph.optimize(poses_p, data_p, CFG, n_iters=8)
    np.testing.assert_allclose(pad.poses.t[:n].numpy(), plain.poses.t.numpy(),
                               atol=2e-3)


def _check_batched_algebra():
    """Pose.identity(batch_shape=...) and retract / inverse / compose over
    (N,) poses equal the per-pose results."""
    rng = np.random.default_rng(2)
    t, q = _random_poses(rng, 5)
    d = tp(rng.normal(size=(5, 6)) * 0.1)
    P = Pose(tp(t), tp(q))
    ident = Pose.identity(batch_shape=(5,))
    assert ident.t.shape == (5, 3) and ident.q.shape == (5, 4)
    both = P.retract(d).inverse().compose(ident.compose(P))
    for i in range(5):
        one = Pose(P.t[i], P.q[i]).retract(d[i]).inverse().compose(
            Pose.identity().compose(Pose(P.t[i], P.q[i])))
        np.testing.assert_array_equal(both.t[i].numpy(), one.t.numpy())
        np.testing.assert_array_equal(both.q[i].numpy(), one.q.numpy())
    e = quat_exp(d[:, 3:])
    np.testing.assert_allclose(quat_multiply(P.q, e).norm(dim=-1).numpy(),
                               1.0, atol=1e-6)


# ------------------------------------------------------------------ tests
# Six tests a file: pytest-xdist's loadscope scheduling queues files by
# their test count, so a file of at most six tests queues behind
# test_nsh_bag.py (six tests, the suite's longest file) and never delays it.
def test_factors_and_graph_data_match_jax(ref):
    _check_factors(ref)
    _check_graph_data(ref)


def test_solves_match_jax_and_dense(ref):
    for m in (1, 9):
        _check_block_tridiag(ref, m)
    _check_woodbury(ref)
    _check_columns_independent()


def test_kernel_mirror_bit_equal_to_plain():
    for case in ("random", "ties", "zero_pivot"):
        _check_mirror(case)


def test_gps_fusion_scenarios():
    _check_gps_drift()
    _check_sim_gps()
    _check_interpolated_gps()


def test_no_gps_padding_and_batched_algebra():
    _check_no_gps_noop()
    _check_padded_graph()
    _check_batched_algebra()
