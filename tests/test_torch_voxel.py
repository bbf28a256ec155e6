"""Port's voxel keys, voxel downsamples and voxel hash map (insert, evict,
grouped octant gather) against the JAX package, bit for bit. The JAX
side runs compiled (jax.jit), as the frame program does: a compile-time
constant leaf divides through its float32 reciprocal there, and the port
reproduces that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.ops import voxel as jvox
from msf_loam_tpu.slam import voxel_map as jvm
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.ops import voxel as tvox
from msf_loam_tpu_torch.slam import voxel_map as tvm

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def _cloud(seed, n=3000, spread=12.0):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    # negative, far (beyond the +-4096 / 8192 origins), huge and exactly
    # on-boundary coordinates
    xyz[:6] = [[-5000.0, 3.0, -1.0], [9000.0, -9000.0, 0.0], [1e6, -1e6, 2.0],
               [0.2, 0.4, -0.2], [-4096.0, 0.0, 4096.0], [-1e9, 1e9, 5.0]]
    mask = rng.uniform(size=n) > 0.25
    return xyz, mask


def test_voxel_keys_negative_and_far():
    xyz, _ = _cloud(0)
    for leaf in (0.2, 0.4):
        want = jax.jit(lambda a, leaf=leaf: jvox.voxel_keys(a, leaf))(xyz)
        np.testing.assert_array_equal(
            tvox.voxel_keys(torch.from_numpy(xyz), leaf).numpy(),
            np.asarray(want))
    # a traced (tensor) leaf divides
    leaf_t = np.float32(0.4)
    want = jax.jit(jvm._leaf_key_dyn)(xyz, leaf_t)
    np.testing.assert_array_equal(
        tvm._leaf_key_dyn(torch.from_numpy(xyz), float(leaf_t)).numpy(),
        np.asarray(want))
    cells = np.array([[-1, -5, 3], [2 ** 31 - 1, -2 ** 31, 0], [7, 8, 9]],
                     np.int32)
    np.testing.assert_array_equal(
        tvm._hash_cells(torch.from_numpy(cells).long(), 1 << 12).numpy(),
        np.asarray(jvm._hash_cells(jnp.asarray(cells), 1 << 12)))


@pytest.mark.parametrize("salted", [False, True])
def test_compact_downsample_bit_equal(salted):
    xyz, mask = _cloud(1)
    salt = np.arange(len(xyz), dtype=np.int32) % 7 if salted else None
    fn = jax.jit(lambda a, m, s: jvox.voxel_downsample_compact_idx(
        a, m, 0.2, 2500, salt=s))
    want = fn(xyz, mask, salt)
    got = tvox.voxel_downsample_compact_idx(
        torch.from_numpy(xyz), torch.from_numpy(mask), 0.2, 2500,
        salt=None if salt is None else torch.from_numpy(salt))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grouped_downsample_bit_equal():
    xyz, mask = _cloud(2)
    world = xyz + np.float32(3.7)
    fn = jax.jit(lambda a, m, w: jvox.voxel_downsample_grouped_idx(
        a, m, 0.4, 2048, w, 2.0, 64))
    want = fn(xyz, mask, world)
    got = tvox.voxel_downsample_grouped_idx(
        torch.from_numpy(xyz), torch.from_numpy(mask), 0.4, 2048,
        torch.from_numpy(world), 2.0, 64)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].max()) == 63           # the budget overflowed


def test_map_insert_evict_gather_bit_equal():
    """Three inserts (the second duplicates leaves, the third overflows
    slabs), an eviction, and the grouped rows gather."""
    H, P = 1 << 12, 8
    jm = jvm.create_map(H, P, 2.0, 0.4)
    tm = tvm.create_map(H, P, 2.0, 0.4, device="cpu")
    for seed, spread in ((3, 10.0), (3, 10.0), (4, 3.0)):
        xyz, mask = _cloud(seed, n=2000, spread=spread)
        xyz[:6] = np.clip(xyz[:6], -60.0, 60.0)
        jm = jvm.insert(jm, jnp.asarray(xyz), jnp.asarray(mask))
        tm = tvm.insert(tm, torch.from_numpy(xyz), torch.from_numpy(mask))
    center = np.array([4.0, -2.0, 0.0], np.float32)
    jm = jvm.evict_far(jm, jnp.asarray(center), 9.0)
    tm = tvm.evict_far(tm, torch.from_numpy(center), 9.0)
    jn = jax.tree.map(np.asarray, jm)
    for f in ("points", "leaf_key", "count", "n_obs"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(), getattr(jn, f),
                                      err_msg=f)
    assert 0 < int(tm.count.sum()) < 6000 and int(tm.count.max()) == P

    q, qmask = _cloud(5, n=500, spread=9.0)
    q[:6] = 0.0
    idx, valid, gid, rep = jax.jit(lambda a, m: jvox.voxel_downsample_grouped_idx(
        a, m, 0.4, 400, a, 2.0, 32))(q, qmask)
    qd = q[np.asarray(idx)]
    want = jvm.gather_candidates_rows_grouped(jm, jnp.asarray(qd), gid, rep)
    got = tvm.gather_candidates_rows_grouped(
        interop.map_from_numpy(jn, "cpu"), torch.from_numpy(qd),
        torch.from_numpy(np.array(gid)).long(),
        torch.from_numpy(np.array(rep)).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (400, 3 * 8 * P)
