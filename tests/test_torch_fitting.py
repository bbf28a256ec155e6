"""The port's per-round scan-to-map association (``mapping.
reuse_candidates=False``) against the JAX package's, on the CPU: the
closed-form fits (``ops/fitting.py``), the per-round k-NN queries
(``voxel_map.query_knn`` / ``query_knn_2r``) and the hook-less matcher
``match_scan2map``. JAX's ``_associate`` reaches no Pallas kernel, so its
CPU path is its real path here.

One JAX compile in this file: a single jitted function returns every JAX
result (the module fixture). Under ``jit`` XLA turns the eigensolver's
divisions by 3 and 6 into multiplies by the float32 reciprocal, as the
port computes them; ``arccos`` and ``cos`` are other implementations in
torch, so centres and normals are held to 1e-5 and validity equal except
where a gate value lies within 1e-5 of its threshold.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import MappingConfig as JMappingConfig
from msf_loam_tpu.core.pointcloud import PointBatch as JPointBatch
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.ops import fitting as jfit
from msf_loam_tpu.slam import mapping as jmapping
from msf_loam_tpu.slam import voxel_map as jvm
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                       MsfLoamConfig)
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.dataio import preprocess, synthetic
from msf_loam_tpu_torch.ops import features as feat_mod
from msf_loam_tpu_torch.ops import fitting
from msf_loam_tpu_torch.slam import mapping
from msf_loam_tpu_torch.slam import voxel_map as vm
from msf_loam_tpu_torch.slam.pipeline import (SlamPipeline,
                                              downsample_features)

torch.set_num_threads(1)

MAP = dict(map_table_size=1 << 10, max_query_points=256,
           max_corner_query_points=128, reuse_candidates=False)


def _sym(rng, n):
    """Seeded symmetric 3x3s and degenerate ones: diagonal (distinct,
    repeated, all equal), rank one, repeated eigenvalues off the axes."""
    A = rng.normal(size=(n, 3, 3))
    A = np.einsum("nij,nkj->nik", A, A)
    deg = [np.diag([3.0, 2.0, 1.0]), np.diag([1.0, 2.0, 2.0]),
           np.diag([2.0, 2.0, 2.0]), np.zeros((3, 3))]
    v = rng.normal(size=3)
    deg.append(np.outer(v, v))
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    deg.append(Q @ np.diag([2.0, 2.0, 0.5]) @ Q.T)
    deg.append(Q @ np.diag([4.0, 1.0, 1.0]) @ Q.T)
    return np.concatenate([A, np.stack(deg)]).astype(np.float32)


def _neighbourhoods(rng, n=64, k=5, kw=16):
    """Near-line and near-plane k- and kw-neighbourhoods at ranges up to
    30 m; some rows with fewer valid neighbours than k."""
    c = rng.uniform(-30, 30, (n, 1, 3))
    d = rng.normal(size=(n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    e = np.cross(d, rng.normal(size=(n, 1, 3)))
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    planar = (np.arange(n) % 2 == 0)[:, None, None]

    def cloud(m, spread):
        s = rng.uniform(-spread, spread, (n, m, 1))
        t = np.where(planar, rng.uniform(-spread, spread, (n, m, 1)),
                     0.02 * rng.normal(size=(n, m, 1)))
        return c + s * d + t * e + 0.01 * rng.normal(size=(n, m, 3))

    near, wide = cloud(k, 0.5), cloud(kw, 1.5)
    nv = rng.uniform(size=(n, k)) > 0.1
    wv = rng.uniform(size=(n, kw)) > 0.2
    return (near.astype(np.float32), nv, wide.astype(np.float32), wv)


def _map_and_queries(rng):
    """A 64-slot map (many hash collisions: one slot can appear twice among
    a query's 8 octant cells) of random points, with exact ties: pairs of
    points mirrored about a dyadic query in one of its octant slabs."""
    H, P, cell = 64, 8, 2.0
    pts = np.full((H, P, 3), vm.EMPTY_COORD, np.float32)
    cnt = rng.integers(0, P - 1, H).astype(np.int32)
    for h in range(H):
        pts[h, :cnt[h]] = rng.uniform(-4, 4, (cnt[h], 3))
    q = rng.uniform(-3.5, 3.5, (120, 3)).astype(np.float32)
    ties = np.array([[1.5, 0.5, 0.25], [-0.75, 1.25, -2.5],
                     [0.25, -1.5, 0.75]], np.float32)
    for t in ties:
        slot = int(vm._hash_cells(vm.neighbor_cells8(
            torch.as_tensor(t[None]), cell), H)[0, 3])
        n = cnt[slot]
        if n + 2 <= P:
            pts[slot, n] = t + np.float32([0.125, 0.0, 0.0])
            pts[slot, n + 1] = t - np.float32([0.125, 0.0, 0.0])
            cnt[slot] = n + 2
    q = np.concatenate([q, ties])
    qmask = rng.uniform(size=q.shape[0]) > 0.05
    m = dict(points=pts, leaf_key=np.zeros((H, P), np.int32), count=cnt,
             n_obs=np.zeros((H, P), np.float32), cell_size=np.float32(cell),
             leaf=np.float32(0.2))
    return m, q, qmask


def _scene():
    """A 16-ring corridor: maps from frame 0 at its true pose, the
    downsampled query clouds of frame 1, the guess 5 cm / 0.01 rad off."""
    fcfg = FeatureConfig(max_points_per_ring=512, max_less_flat=1024)
    cfg = MsfLoamConfig(features=fcfg, mapping=MappingConfig(**MAP))
    mc = cfg.mapping
    world = synthetic.World.corridor(seed=0, size=12.0)
    feats = []
    for i in range(2):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.25 * i, 0.0, 0.0]), np.eye(3), n_rings=16,
            pts_per_ring=900, noise=0.004, seed=i)
        img = preprocess.preprocess_scan(xyz, ring, fcfg, 16, device="cpu")
        feats.append(feat_mod.extract_features(
            img, torch.tensor(0.1 * i), fcfg))
    cmap = vm.create_map(mc.map_table_size, mc.map_cell_capacity,
                         mc.map_cell_size, mc.line_resolution, device="cpu")
    smap = vm.create_map(mc.map_table_size, mc.map_cell_capacity,
                         mc.map_cell_size, mc.plane_resolution, device="cpu")
    f0 = feats[0]
    cmap = vm.insert(cmap, f0.corner_less_sharp.xyz, f0.corner_less_sharp.mask)
    smap = vm.insert(smap, f0.surf_less_flat.xyz, f0.surf_less_flat.mask)
    corner = downsample_features(feats[1].corner_less_sharp,
                                 mc.line_resolution, mc.corner_query_points)
    surf = downsample_features(feats[1].surf_less_flat, mc.plane_resolution,
                               mc.max_query_points)
    c, s = np.cos(0.01), np.sin(0.01)
    guess = Pose(torch.tensor([0.30, 0.05, 0.0]),
                 torch.tensor([c, 0.0, 0.0, s], dtype=torch.float32))
    return cfg, cmap, smap, corner, surf, guess


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    A = _sym(rng, 96)
    near, nv, wide, wv = _neighbourhoods(rng)
    m, q, qmask = _map_and_queries(rng)
    # the octant candidates of the same queries, for the selection halves
    cand, occup, _ = vm.octant_candidates(
        T(m["points"]), T(m["count"]), 2.0, T(q), m["points"].shape[0])
    cand, occup = cand.numpy(), occup.numpy()
    b = rng.normal(size=(A.shape[0], 3)).astype(np.float32)
    cfg, cmap, smap, corner, surf, guess = _scene()

    jcfg = JMappingConfig(**MAP)
    jmap = lambda d: jvm.VoxelHashMap(**{k: jnp.asarray(v)
                                         for k, v in d.items()})
    jpb = lambda pb: JPointBatch(*(jnp.asarray(interop.to_numpy(x))
                                   for x in pb))

    def run(A, near, nv, wide, wv, b, m, q, qmask, cand, occup, cm, sm,
            corner, surf, t, qq):
        mres = jmapping.match_scan2map(cm, sm, corner, surf, JPose(t, qq),
                                       jcfg)
        return dict(
            eig=jfit.eigh3x3(A), line=jfit.fit_lines(near, nv, 3.0),
            plane=jfit.fit_planes(near, nv, 0.2),
            two=jfit.fit_planes_two_scale(near, nv, wide, wv, 0.2,
                                          min_wide=5),
            solve=jfit._solve3x3(A, b),
            knn=jvm.query_knn(m, q, qmask, k=5),
            knn2=jvm.query_knn_2r(m, q, qmask, k=5, k2=16),
            sel=jvm.select_knn(cand, occup, q, m.cell_size, k=5),
            sel2=jvm.select_knn_2r(cand, occup, q, m.cell_size, k=5, k2=16),
            pose=(mres.pose.t, mres.pose.q), n=(mres.n_edge, mres.n_plane))

    want = jax.jit(run)(
        A, near, nv, wide, wv, b, jmap(m), q, qmask, cand, occup,
        jmap(interop.to_numpy(cmap)), jmap(interop.to_numpy(smap)),
        jpb(corner), jpb(surf), guess.t.numpy(), guess.q.numpy())
    want = jax.tree.map(np.asarray, want)
    return dict(A=A, near=near, nv=nv, wide=wide, wv=wv, b=b, m=m, q=q,
                qmask=qmask, cand=cand, occup=occup, cfg=cfg, cmap=cmap, smap=smap, corner=corner,
                surf=surf, guess=guess, want=want)


T = torch.as_tensor


def _eig_np(A):
    w = np.linalg.eigvalsh(A.astype(np.float64))[..., ::-1]
    return w


def test_eigh3x3_seeded_and_degenerate(case):
    """Eigenvalues within 1e-5 (relative to the largest) on every matrix;
    eigenvectors within 1e-5 (up to sign) where their eigenvalue is
    separated from the others by more than 1e-3."""
    w, V = fitting.eigh3x3(T(case["A"]))
    jw, jV = case["want"]["eig"]
    scale = np.maximum(np.abs(jw).max(-1, keepdims=True), 1e-6)
    np.testing.assert_allclose(w.numpy() / scale, jw / scale, atol=1e-5)
    w64 = _eig_np(case["A"])
    for i in range(3):
        gap = np.min(np.abs(w64[:, [i]] - np.delete(w64, i, 1)), 1)
        sep = gap > 1e-3 * np.maximum(np.abs(w64).max(1), 1e-6)
        d = np.abs((V.numpy()[:, :, i] * jV[:, :, i]).sum(-1))
        assert np.all(d[sep] > 1 - 1e-5), (i, d[sep].min())


def _flips_at_margins(got, want, margin):
    """Validity equal except where the gate margin is under 1e-5."""
    bad = (got != want) & (np.abs(margin) > 1e-5)
    assert not bad.any(), np.nonzero(bad)


def test_fits_against_jax(case):
    """fit_lines, fit_planes and fit_planes_two_scale on near-line and
    near-plane neighbourhoods with missing neighbours: centres and normals
    within 1e-5 (normals up to sign) where both are valid, validity equal
    but at gate margins."""
    near, nv, wide, wv = (T(case[k]) for k in ("near", "nv", "wide", "wv"))
    want = case["want"]
    line = fitting.fit_lines(near, nv, 3.0)
    plane = fitting.fit_planes(near, nv, 0.2)
    two = fitting.fit_planes_two_scale(near, nv, wide, wv, 0.2, min_wide=5)
    for got, (jc, jn, jv), name in ((line, want["line"], "line"),
                                    (plane, want["plane"], "plane"),
                                    (two, want["two"], "two")):
        c, n, v = (x.numpy() for x in got)
        both = v & jv
        np.testing.assert_allclose(c, jc, atol=1e-5, err_msg=name)
        d = np.abs((n * jn).sum(-1))
        assert np.all(d[both] > 1 - 1e-5), (name, d[both].min())
        # gate margins from float64 eigenvalues of the port's neighbourhoods
        w = np.linalg.eigvalsh(np.einsum(
            "nki,nkj->nij", (case["near"] - c[:, None]) * case["nv"][..., None],
            (case["near"] - c[:, None]) * case["nv"][..., None]))[..., ::-1]
        top = np.maximum(w[:, 0], 1e-12)
        margin = np.minimum(np.abs(w[:, 0] - 3.0 * w[:, 1]) / top,
                            np.abs(w[:, 1] - 0.05 * w[:, 0]) / top)
        resid = np.abs(np.einsum("ni,nki->nk", n, case["near"] - c[:, None]))
        margin = np.minimum(margin, np.abs(resid - 0.2).min(-1))
        if name == "two":
            margin = np.minimum(margin, np.abs(np.abs(np.einsum(
                "ni,nki->nk", n, case["wide"] - c[:, None])) - 0.2).min(-1))
        _flips_at_margins(v, jv, margin)
    assert line.valid.any() and plane.valid.any() and (~plane.valid).any()


def test_query_knn_bit_equal(case):
    """query_knn and query_knn_2r on a collision-heavy 64-slot map, and
    their selection halves select_knn / select_knn_2r on the same octant
    candidates: d2 bit-equal, the picked points and validity equal, ties
    (duplicate slots, mirrored points) taken in lax.top_k's order."""
    m = interop.map_from_numpy(type("M", (), case["m"]), device="cpu")
    q, qmask = T(case["q"]), T(case["qmask"])
    cand, occup = T(case["cand"]), T(case["occup"])
    got = vm.query_knn(m, q, qmask, k=5)
    got2 = vm.query_knn_2r(m, q, qmask, k=5, k2=16)
    sel = vm.select_knn(cand, occup, q, 2.0, k=5)
    sel2 = vm.select_knn_2r(cand, occup, q, 2.0, k=5, k2=16)
    w = case["want"]
    for g, w in ((got, w["knn"]), (got2, w["knn2"]), (sel, w["sel"]),
                 (sel2, w["sel2"])):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), b)
    # the ties are there: a row whose k nearest hold two equal distances
    d2 = got2[3].numpy()
    assert (np.diff(d2, axis=1)[d2[:, 1:] < 1e37] == 0).any()


def test_matcher_pose_against_jax(case):
    """match_scan2map with reuse_candidates=False (no hooks): the port's
    pose within 1e-5 m / 1e-5 of JAX's, the correspondence counts within
    0.5% (gate-margin flips)."""
    res = mapping.match_scan2map_core(case["cmap"], case["smap"],
                                      case["corner"], case["surf"],
                                      case["guess"], case["cfg"].mapping)
    jt, jq = case["want"]["pose"]
    np.testing.assert_allclose(res.pose.t.numpy(), jt, atol=1e-5)
    np.testing.assert_allclose(res.pose.q.numpy(), jq, atol=1e-5)
    for a, b in zip((res.n_edge, res.n_plane), case["want"]["n"]):
        assert abs(float(a) - float(b)) <= max(1.0, 0.005 * float(b))
    assert float(res.n_plane) > 50


def test_solve3x3_against_jax(case):
    """The adjugate solve: det within 1e-5 (entries are O(1-10); XLA
    contracts the cofactor products into fused multiply-adds, the port
    rounds each product), x within 1e-4 relative where |det| > 1e-2."""
    x, det = fitting._solve3x3(T(case["A"]), T(case["b"]))
    jx, jdet = case["want"]["solve"]
    np.testing.assert_allclose(det.numpy(), jdet, rtol=0, atol=1e-5)
    ok = np.abs(jdet) > 1e-2
    np.testing.assert_allclose(x.numpy()[ok], jx[ok], rtol=1e-4, atol=1e-5)


def test_config_accepts_per_round_association():
    """MsfLoamConfig accepts reuse_candidates=False, and the dense frame
    on that path drives 3 corridor frames to within 2 cm of ground truth
    on the CPU."""
    fcfg = FeatureConfig(max_points_per_ring=512, max_less_flat=1024)
    cfg = MsfLoamConfig(features=fcfg, mapping=MappingConfig(**MAP))
    assert not cfg.mapping.reuse_candidates
    pipe = SlamPipeline(cfg, device="cpu")
    world = synthetic.World.corridor(seed=0, size=12.0)
    for i in range(3):
        xyz, ring = synthetic.simulate_scan(
            world, np.array([0.25 * i, 0.0, 0.0]), np.eye(3), n_rings=16,
            pts_per_ring=900, noise=0.004, seed=i)
        pipe.process_ring_image(preprocess.preprocess_scan(
            xyz, ring, fcfg, 16, device="cpu"), 0.1 * i)
    np.testing.assert_allclose(pipe.pose_map.t.numpy(), [0.5, 0.0, 0.0],
                               atol=0.02)
