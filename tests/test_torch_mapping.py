"""Port's select_fit plain version against the JAX package's Pallas kernel
itself in interpret mode: line / plane / plane2, the port in both of its
candidate layouts (planar (3, N, C) and rows (N, 3C)), plus the odometry
plane-support shape (C = k = 8). match_scan2map_core is held to the JAX
fused-selection grouped-gather path (fused_select="on") frame by frame in
tests/test_torch_pipeline.py, where its compile is shared with the whole
frame."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.ops.select_fit import select_fit_pallas
from msf_loam_tpu_torch.ops.select_fit import select_fit

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def _slabs(seed, n=96, c=64, shape="plane"):
    """Candidate slabs around each query (~15% invalid at the 1e9
    sentinel), squashed onto a tilted plane or a line."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)
    off = rng.uniform(-1.4, 1.4, (n, c, 3)).astype(np.float32)
    if shape == "plane":
        nv = rng.normal(size=(n, 3)).astype(np.float32)
        nv /= np.linalg.norm(nv, axis=-1, keepdims=True)
        off -= (off @ nv[..., None]) * nv[:, None, :]
        off += 0.02 * rng.normal(size=(n, c, 1)).astype(np.float32) * nv[:, None, :]
    else:
        dv = rng.normal(size=(n, 3)).astype(np.float32)
        dv /= np.linalg.norm(dv, axis=-1, keepdims=True)
        t = rng.uniform(-1.0, 1.0, (n, c, 1)).astype(np.float32)
        off = t * dv[:, None, :] + 0.01 * rng.normal(size=(n, c, 3)).astype(np.float32)
    cand = q[:, None, :] + off
    valid = rng.uniform(size=(n, c)) > 0.15
    valid[:3] = False                       # rows with no candidate at all
    cand = np.where(valid[..., None], cand, np.float32(1e9))
    return np.ascontiguousarray(np.transpose(cand, (2, 0, 1))), q


@pytest.mark.parametrize("mode", ["line", "plane", "plane2", "support8"])
def test_select_fit_plain_matches_pallas_interpret(mode):
    """``support8`` is the odometry call: 8 supports per query, k = 8,
    plane mode, radius 1e17 (keeps every real support, drops the 1e9
    sentinels), min_count = 8."""
    if mode == "support8":
        planar, q = _slabs(8, n=192, c=8)
        kw = dict(k=8, mode="plane", min_count=8, tol=0.2)
        r2s = r2w = 1e17
    else:
        planar, q = _slabs(7, shape="line" if mode == "line" else "plane")
        kw = dict(k=5, mode=mode, min_count=5, min_wide=5, eig_ratio=3.0,
                  tol=0.2)
        r2s, r2w = 1.0, 4.0
    want = select_fit_pallas(jnp.asarray(planar), jnp.asarray(q), r2s, r2w,
                             interpret=True, **kw)
    rows = np.ascontiguousarray(
        np.transpose(planar, (1, 0, 2)).reshape(planar.shape[1], -1))
    for cand in (planar, rows):
        got = select_fit(torch.from_numpy(cand), torch.from_numpy(q), r2s,
                         r2w, **kw)
        wd2, gd2 = np.asarray(want.d2), got.d2.numpy()
        fin = wd2 < 1e37
        # both compute d2 from the same float32 differences; the compiled
        # reference may contract products into fused multiply-adds
        np.testing.assert_allclose(gd2[fin], wd2[fin], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(gd2 >= 1e37, ~fin)
        wv, gv = np.asarray(want.valid), got.valid.numpy()
        # gates compare float32 eigenvalues / residual maxima summed in
        # another order: only knife-edge rows may flip
        assert (wv == gv).mean() >= 0.98
        assert gv.sum() > 20
        both = wv & gv
        np.testing.assert_allclose(got.center.numpy()[both],
                                   np.asarray(want.center)[both], atol=1e-4)
        dots = np.abs(np.sum(got.normal.numpy()[both]
                             * np.asarray(want.normal)[both], axis=-1))
        assert dots.min() > 1 - 1e-4
