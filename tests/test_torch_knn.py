"""The port's k-NN (``msf_loam_tpu_torch.ops.pallas_knn``: on the CPU its
plain version) against the JAX package's Pallas kernel ``knn_pallas`` in
interpret mode, at the shapes and block sizes of tests/test_pallas_knn.py.

d2 agrees to 1e-6 relative (interpret mode compiles on XLA:CPU, which may
contract a multiply-add that the port rounds twice); indices agree, except
that among exactly tied d2 the Pallas kernel may order its slots
differently, so tied indices are compared as sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.ops import pallas_knn as jknn
from msf_loam_tpu_torch.ops import pallas_knn as tknn

torch.set_num_threads(1)


def _inputs(Q, M, seed, valid_frac=0.9, dup=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-5, 5, size=(Q, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, size=(M, 3)).astype(np.float32)
    if dup:
        r[M - dup:] = r[:dup]                      # exact ties
    rmask = rng.uniform(size=M) < valid_frac
    return q, r, rmask


def _jax(q, r, rmask, k, bq, bm):
    d, i = jknn.knn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(rmask),
                           k=k, bq=bq, bm=bm, interpret=True)
    return np.asarray(d), np.asarray(i)


def _port(q, r, rmask, k):
    d, i = tknn.knn_pallas(torch.from_numpy(q), torch.from_numpy(r),
                           torch.from_numpy(rmask), k=k)
    return d.numpy(), i.numpy()


def _assert_same(got_d, got_i, want_d, want_i, r, rmask, q):
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6, atol=0)
    for row in range(want_d.shape[0]):
        for val in np.unique(want_d[row]):
            sel = want_d[row] == val
            assert sorted(got_i[row][sel]) == sorted(want_i[row][sel]), row
    # the contract, independent of the reference
    assert (np.diff(got_d, axis=1) >= 0).all()
    empty = got_d >= 3e38
    assert (got_i[empty] == -1).all() and (got_d[empty] == np.float32(3e38)).all()
    assert (got_i[~empty] >= 0).all() and rmask[got_i[~empty]].all()
    d_direct = ((q[:, None, :] - r[np.maximum(got_i, 0)]) ** 2).sum(-1)
    np.testing.assert_allclose(got_d[~empty], d_direct[~empty], rtol=1e-5)


@pytest.mark.parametrize("Q,M,k,dup", [(64, 300, 5, 40), (100, 2500, 8, 0),
                                       (17, 33, 3, 8)])
def test_knn_matches_pallas_interpret(Q, M, k, dup):
    q, r, rmask = _inputs(Q, M, seed=Q + M, dup=dup)
    want_d, want_i = _jax(q, r, rmask, k, bq=32, bm=128)
    got_d, got_i = _port(q, r, rmask, k)
    _assert_same(got_d, got_i, want_d, want_i, r, rmask, q)


def test_knn_sentinels_and_masked_refs():
    """Fewer valid refs than k: the empty slots are (3e38, -1) on both
    sides, and the masked refs (some nearer than every valid one) are never
    returned."""
    q, r, _ = _inputs(17, 33, seed=5)
    rmask = np.zeros(33, bool)
    rmask[[4, 20]] = True
    r[5:9] = q[0]                                   # masked, at distance 0
    want_d, want_i = _jax(q, r, rmask, 5, bq=32, bm=128)
    got_d, got_i = _port(q, r, rmask, 5)
    _assert_same(got_d, got_i, want_d, want_i, r, rmask, q)
    assert (got_i[:, 2:] == -1).all() and (got_d[:, 2:] == np.float32(3e38)).all()
    assert set(np.unique(got_i[:, :2])) == {4, 20}


def test_knn_auto_is_the_kernel_entry_and_chunking_is_exact():
    """``knn_auto`` takes the same path; the plain version's result does
    not depend on its chunk size (the stable merge keeps the lowest index
    among ties across chunks), nor on the kernel's split of the ref axis."""
    q, r, rmask = _inputs(40, 900, seed=9, dup=300)
    q[:20] = r[:20]                      # queries on a duplicated ref pair
    rmask[600:] = True
    rmask[10:20] = False                 # ... whose original is masked
    qt, rt, mt = (torch.from_numpy(a) for a in (q, r, rmask))
    d0, i0 = tknn.knn_auto(qt, rt, mt, k=7)
    for chunk in (64, 300, 4096):
        d1, i1 = tknn.knn_plain(qt, rt, mt, 7, chunk=chunk)
        assert torch.equal(d0, d1) and torch.equal(i0, i1)
    # ties resolve to the lowest index: where a duplicate (600..899 repeat
    # 0..299) is returned, its valid original is returned before it
    n_dup = 0
    for row in i0.numpy():
        for pos, j in enumerate(row):
            if j >= 600 and rmask[j - 600]:
                assert j - 600 in row[:pos], row
                n_dup += 1
    assert n_dup >= 10
    S, rl = tknn.split_ranges(4096, 65536)
    assert S * rl >= 65536 and rl % 1024 == 0 and S * (4096 // 128) >= 132
    with pytest.raises(ValueError):
        tknn.knn_pallas(qt, rt, mt, k=17)
