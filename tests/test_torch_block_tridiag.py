"""The port's segmented block-tridiagonal solve
(``msf_loam_tpu_torch.ops.block_tridiag``) on the CPU: its plain version
against the JAX package's segmented solve
(``parallel/distributed_ba.distributed_tridiag_solve_multi``, one segment
a device of the 8-device CPU mesh) on the same segments, against float64
dense solves on edge shapes, and its segment rule.

One JAX compile in this file (the distributed solve at N = 64, m = 9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.parallel import distributed_ba
from msf_loam_tpu.parallel import mesh as mesh_mod
from msf_loam_tpu_torch.ops import block_tridiag as bt

torch.set_num_threads(1)


def _system(rng, N, m):
    """D = GGᵀ + 6I, U scaled by 0.3 (as tests/test_torch_posegraph.py's
    ``_random_tridiag``), B standard normal; float32."""
    D = rng.normal(size=(N, 6, 6))
    D = np.einsum("nij,nkj->nik", D, D) + 6.0 * np.eye(6)
    U = rng.normal(size=(N - 1, 6, 6)) * 0.3
    B = rng.normal(size=(N, 6, m))
    return tuple(a.astype(np.float32) for a in (D, U, B))


def _dense_solve(D, U, B):
    """float64 solve of the assembled 6N x 6N system."""
    N, m = B.shape[0], B.shape[2]
    H = np.zeros((6 * N, 6 * N))
    for i in range(N):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
    for i in range(N - 1):
        H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
        H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    return np.linalg.solve(H, B.reshape(6 * N, m).astype(np.float64)
                           ).reshape(N, 6, m)


def _plain(D, U, B, seg_len=None):
    t = lambda a: torch.as_tensor(a)
    return bt.block_tridiag_plain(t(D), t(U), t(B), seg_len).numpy()


def test_plain_matches_jax_segmented_solve():
    """N = 64 in JAX's 8 segments of 8 (the n_data=8 mesh of
    tests/test_parallel.py), m = 9: both float32 solvers within 1e-5 of
    float64, and within 2e-5 of each other (LAPACK's LU multiplies by
    reciprocal pivots, the port divides)."""
    D, U, B = _system(np.random.default_rng(7), 64, 9)
    mesh = mesh_mod.make_mesh(n_map=1, n_data=8)
    want = np.asarray(distributed_ba.distributed_tridiag_solve_multi(
        mesh, jnp.asarray(D), jnp.asarray(U), jnp.asarray(B)))
    got = _plain(D, U, B, seg_len=8)
    dense = _dense_solve(D, U, B)
    np.testing.assert_allclose(got, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(want, dense, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def _check_dense(cases):
    for N, m, seg_len in cases:
        D, U, B = _system(np.random.default_rng(N * 100 + m), N, m)
        np.testing.assert_allclose(_plain(D, U, B, seg_len),
                                   _dense_solve(D, U, B), atol=1e-5, rtol=0,
                                   err_msg=f"N={N} m={m} seg_len={seg_len}")


def test_small_systems_against_dense():
    """N = 1, 2, 3 (one segment under the rule) and P = 1 by force, at
    m = 1 and 49, within 1e-5 of float64."""
    _check_dense([(1, 1, None), (1, 49, None), (2, 49, None), (3, 1, None),
                  (30, 2, 30), (30, 49, 40)])


def test_segment_layouts_against_dense():
    """Segments of 2 (no interior: the separator is the whole system), a
    ragged last segment (5, 5, 5, 5, 3), a lone last block joined to its
    neighbour (4, 5), and the rule at N = 64 (11 x 5 + 9) with m = 1 and
    49, within 1e-5 of float64."""
    _check_dense([(8, 3, 2), (23, 4, 5), (9, 4, 4), (64, 1, None),
                  (64, 49, None)])


def test_columns_independent_under_segmentation():
    """[rhs | W] in one solve equals the two groups solved apart, bit for
    bit, under the rule and forced segments (the Woodbury solve's one
    launch)."""
    D, U, B = _system(np.random.default_rng(3), 23, 7)
    for seg_len in (None, 2, 5, 23):
        both = _plain(D, U, B, seg_len)
        apart = np.concatenate([_plain(D, U, B[..., :1], seg_len),
                                _plain(D, U, B[..., 1:], seg_len)], -1)
        np.testing.assert_array_equal(both, apart)


def test_segment_rule_and_wrapper_on_cpu():
    """L = max(2, isqrt(2N)); a lone last block joins its neighbour; P = 1
    exactly for N <= 3; the chain depth at KITTI size; the wrapper takes the
    plain version on CPU tensors and refuses bad shapes and segments."""
    assert bt.segments(8192) == (128, 64)
    assert bt.chain_depth(8192, 128, 64) == 507
    assert [bt.segments(n)[1] for n in range(1, 8)] == [1, 1, 1, 2, 2, 2, 2]
    for n in range(2, 300):
        for seg_len in (None, 2, 3, 7):
            L, P = bt.segments(n, seg_len)
            last = n - (P - 1) * L
            assert 2 <= last <= L + 1 or P == 1, (n, seg_len)
    with pytest.raises(ValueError):
        bt.segments(10, 1)
    D, U, B = (torch.as_tensor(a) for a in _system(
        np.random.default_rng(5), 12, 3))
    assert torch.equal(bt.block_tridiag(D, U, B), bt.block_tridiag_plain(
        D, U, B))
    with pytest.raises(ValueError):
        bt.block_tridiag(D, U[:-1], B)
