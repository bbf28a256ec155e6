"""The port's IMU stack (``msf_loam_tpu_torch.imu``) against the JAX
package's on the same numpy-seeded inputs: sample buffer, preintegration
in both lowerings, whitening, residual, interpolation, the IMU factor and
its pre-solve, deskew, the gravity/velocity initialisation and the bias
window solve. Every function after the preintegration starts from the JAX
preintegration (carried over by ``interop``), so each comparison covers
one function. Tolerances are stated per test: float32 arithmetic summed in
another order (XLA's fused multiply-adds, LAPACK against PyTorch's
factorisations)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.config import ImuConfig as JImuConfig
from msf_loam_tpu.core.pointcloud import PointBatch as JPointBatch
from msf_loam_tpu.core.pointcloud import ScanFeatures as JScanFeatures
from msf_loam_tpu.core.se3 import Pose as JPose
from msf_loam_tpu.imu import bias_estimator as jbias
from msf_loam_tpu.imu import buffer as jbuffer
from msf_loam_tpu.imu import deskew as jdeskew
from msf_loam_tpu.imu import gravity_init as jgrav
from msf_loam_tpu.imu import imu_factor as jfactor
from msf_loam_tpu.imu import preintegration as jpre
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import ImuConfig
from msf_loam_tpu_torch.core.pointcloud import PointBatch, ScanFeatures
from msf_loam_tpu_torch.core.se3 import Pose
from msf_loam_tpu_torch.imu import bias_estimator, deskew, gravity_init
from msf_loam_tpu_torch.imu import buffer as tbuffer
from msf_loam_tpu_torch.imu import imu_factor, preintegration

torch.set_num_threads(1)

S = 64
G = np.array([0.0, 0.0, 9.81], np.float32)
BA = np.array([0.03, -0.02, 0.01], np.float32)
BG = np.array([0.004, -0.003, 0.002], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _window(seed=0, n_valid=40, hole=11, nan_at=None):
    rng = np.random.default_rng(seed)
    dts = np.full(S, 0.0025, np.float32)
    accs = (G + rng.normal(0, 0.4, (S, 3))).astype(np.float32)
    gyrs = rng.normal(0, 0.3, (S, 3)).astype(np.float32)
    valid = np.arange(S) < n_valid
    dts[n_valid:] = 0.0                     # padding
    valid[hole] = False                     # a hole with a nonzero dt
    if nan_at is not None:
        accs[nan_at] = np.nan
    return dts, accs, gyrs, valid


def _jax_pre(w, mode="assoc", ba=BA, bg=BG):
    return jpre.preintegrate(*(jnp.asarray(a) for a in w), jnp.asarray(ba),
                             jnp.asarray(bg), JImuConfig(preint_mode=mode))


def _port_pre(w, mode="assoc", ba=BA, bg=BG):
    dts, accs, gyrs, valid = w
    return preintegration.preintegrate(
        _t(dts), _t(accs), _t(gyrs), torch.from_numpy(valid), _t(ba), _t(bg),
        ImuConfig(preint_mode=mode))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_scaled(got, want, frac):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def _state(rng, p_scale=0.3):
    q = rng.normal(size=4) * 0.1
    q[0] = 1.0
    q /= np.linalg.norm(q)
    return dict(t=(rng.normal(size=3) * p_scale).astype(np.float32),
                q=q.astype(np.float32),
                v=(rng.normal(size=3) * 0.5).astype(np.float32))


def _jstate(s, ba=BA, bg=BG):
    return jfactor.ImuState(JPose(jnp.asarray(s["t"]), jnp.asarray(s["q"])),
                            jnp.asarray(s["v"]), jnp.asarray(ba),
                            jnp.asarray(bg))


def _tstate(s, ba=BA, bg=BG):
    return imu_factor.ImuState(Pose(_t(s["t"]), _t(s["q"])), _t(s["v"]),
                               _t(ba), _t(bg))


def test_imu_buffer_window_bit_equal():
    rng = np.random.default_rng(1)
    jb, tb = jbuffer.ImuBuffer(), tbuffer.ImuBuffer()
    t = 0.0
    for _ in range(300):
        t += 0.0025 + rng.uniform(-3e-4, 3e-4)
        acc, gyr = rng.normal(size=3), rng.normal(size=3)
        jb.add(t, acc, gyr)
        tb.add(t, acc, gyr)
    for start, end, cap in ((0.1, 0.2, 64), (0.3, 0.7, 64), (0.5, 0.55, 8),
                            (2.0, 2.1, 64), (0.25, 0.25, 64)):
        a, b = jb.window(start, end, cap), tb.window(start, end, cap)
        for f in ("dts", "accs", "gyrs", "valid"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (start, f)


@pytest.mark.parametrize("mode", ["assoc", "scan"])
def test_preintegrate_matches_jax(mode):
    """64-slot window with padding, a hole and nonzero biases: deltas to
    1e-5 absolute, Jacobian and covariance to 1e-4 of their largest entry,
    the per-sample buffers to 1e-5."""
    w = _window()
    want = _np(_jax_pre(w, mode))
    got = _port_pre(w, mode)
    for f in ("delta_p", "delta_q", "delta_v", "sum_dt", "delta_p_buf",
              "delta_q_buf", "delta_v_buf", "sum_dt_buf"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=1e-5, err_msg=f)
    _close_scaled(got.jacobian.numpy(), want.jacobian, 1e-4)
    _close_scaled(got.covariance.numpy(), want.covariance, 1e-4)
    assert int(got.n_samples) == int(want.n_samples) == 39


def test_factor_functions_match_jax():
    """sqrt_information (1e-3 of its largest entry: a 15x15 float32 inverse
    of a covariance spanning ~8 decades), evaluate_residual,
    interpolate_delta, imu_factor_prep / imu_factor_blocks_from_prep and
    imu_factor_full (1e-4 relative to each output's largest entry)."""
    jp = _jax_pre(_window(seed=2))
    tp = interop.preintegration_from_numpy(_np(jp), "cpu")
    _close_scaled(preintegration.sqrt_information(tp).numpy(),
                  jpre.sqrt_information(jp), 1e-3)

    rng = np.random.default_rng(4)
    si, sj = _state(rng), _state(rng)
    g = jnp.asarray(G)
    want = jpre.evaluate_residual(
        jp, *(jnp.asarray(si[f]) for f in "tqv"), jnp.asarray(BA),
        jnp.asarray(BG), *(jnp.asarray(sj[f]) for f in "tqv"),
        jnp.asarray(BA * 1.1), jnp.asarray(BG * 0.9), g)
    got = preintegration.evaluate_residual(
        tp, *(_t(si[f]) for f in "tqv"), _t(BA), _t(BG),
        *(_t(sj[f]) for f in "tqv"), _t(BA * 1.1), _t(BG * 0.9), _t(G))
    _close_scaled(got.numpy(), want, 1e-4)

    dt = rng.uniform(-0.01, 0.12, 50).astype(np.float32)
    wp, wq = jpre.interpolate_delta(jp, jnp.asarray(dt))
    gp, gq = preintegration.interpolate_delta(tp, _t(dt))
    np.testing.assert_allclose(gp.numpy(), wp, atol=1e-6)
    np.testing.assert_allclose(gq.numpy(), wq, atol=1e-6)

    sq = jpre.sqrt_information(jp)
    jprep = jfactor.imu_factor_prep(jp, _jstate(si), g, sqrt_info=sq)
    tprep = imu_factor.imu_factor_prep(tp, _tstate(si), _t(G),
                                       sqrt_info=_t(sq))
    for f in jfactor.ImuFactorPrep._fields:
        _close_scaled(getattr(tprep, f).numpy(), getattr(jprep, f), 1e-4)
    jb = jfactor.imu_factor_blocks_from_prep(
        jprep, JPose(jnp.asarray(sj["t"]), jnp.asarray(sj["q"])),
        jnp.asarray(sj["v"]))
    tb = imu_factor.imu_factor_blocks_from_prep(
        tprep, Pose(_t(sj["t"]), _t(sj["q"])), _t(sj["v"]))
    _close_scaled(tb.r.numpy(), jb.r, 1e-4)
    _close_scaled(tb.J.numpy(), jb.J, 1e-4)
    # the monolithic factor agrees with the decomposed one on both sides
    full = imu_factor.imu_factor_blocks(tp, _tstate(si), _tstate(sj), _t(G),
                                        sqrt_info=_t(sq))
    _close_scaled(full.r.numpy(), jb.r, 1e-4)
    _close_scaled(full.J.numpy(), jb.J, 1e-4)
    jr, jJ = jfactor.imu_factor_full(jp, _jstate(si), _jstate(sj), g,
                                     sqrt_info=sq)
    tr, tJ = imu_factor.imu_factor_full(tp, _tstate(si), _tstate(sj), _t(G),
                                        sqrt_info=_t(sq))
    _close_scaled(tr.numpy(), jr, 1e-4)
    _close_scaled(tJ.numpy(), jJ, 1e-4)


def test_imu_presolve_matches_jax():
    """Six Gauss-Newton iterations of the IMU-only pre-solve from a shared
    state: pose to 1e-5 m / 1e-5, velocity to 1e-4 m/s."""
    jp = _jax_pre(_window(seed=3))
    tp = interop.preintegration_from_numpy(_np(jp), "cpu")
    si = _state(np.random.default_rng(5))
    want = jfactor.imu_presolve(jp, _jstate(si), jnp.asarray(G))
    got = imu_factor.imu_presolve(tp, _tstate(si), _t(G))
    np.testing.assert_allclose(got.pose.t.numpy(), want.pose.t, atol=1e-5)
    np.testing.assert_allclose(got.pose.q.numpy(), want.pose.q, atol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), want.v, atol=1e-4)


def _clouds(rng, n=120):
    def pb():
        return dict(xyz=rng.uniform(-8, 8, (n, 3)).astype(np.float32),
                    rel_time=rng.uniform(0, 0.1, n).astype(np.float32),
                    ring=rng.integers(0, 8, n).astype(np.int32),
                    mask=rng.uniform(size=n) < 0.9)
    names = ("full", "corner_sharp", "corner_less_sharp", "surf_flat",
             "surf_less_flat")
    return {k: pb() for k in names}


def test_deskew_functions_match_jax():
    """deskew_terms, undistort_rotation_only / _full and their five-cloud
    forms: points to 1e-5 m."""
    jp = _jax_pre(_window(seed=6))
    tp = interop.preintegration_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(7)
    c = _clouds(rng)
    jscan = JScanFeatures(jnp.float32(1.0), **{
        k: JPointBatch(**{f: jnp.asarray(a) for f, a in v.items()})
        for k, v in c.items()})
    tscan = interop.scan_features_from_numpy(_np(jscan), "cpu")
    s = _state(rng)
    pose_j = JPose(jnp.asarray(s["t"]), jnp.asarray(s["q"]))
    pose_t = Pose(_t(s["t"]), _t(s["q"]))

    wd = jdeskew.deskew_terms(jp, jscan.full.rel_time, jnp.asarray(G))
    gd = deskew.deskew_terms(tp, tscan.full.rel_time, _t(G))
    for f in ("delta_p", "delta_q", "dt", "gravity"):
        np.testing.assert_allclose(getattr(gd, f).numpy(), getattr(wd, f),
                                   atol=1e-6)
    pairs = [(jdeskew.undistort_scan_rotation_only(jscan, jp),
              deskew.undistort_scan_rotation_only(tscan, tp)),
             (jdeskew.undistort_scan_full(jscan, jp, pose_j,
                                          jnp.asarray(s["v"]), jnp.asarray(G)),
              deskew.undistort_scan_full(tscan, tp, pose_t, _t(s["v"]),
                                         _t(G)))]
    for want, got in pairs:
        for k in c:
            np.testing.assert_allclose(getattr(got, k).xyz.numpy(),
                                       getattr(want, k).xyz, atol=1e-5)
            assert np.array_equal(getattr(got, k).mask.numpy(),
                                  getattr(want, k).mask)


def _gravity_problem(seed, N=8):
    """A rotating, accelerating trajectory with preintegrated pairs (from
    the JAX preintegration), noise, and one unusable pair."""
    rng = np.random.default_rng(seed)
    p = np.cumsum(rng.normal(0, 0.05, (N, 3)), axis=0).astype(np.float32)
    q = np.stack([np.array([np.cos(0.05 * i), 0, 0, np.sin(0.05 * i)])
                  for i in range(N)]).astype(np.float32)
    dt = np.full(N - 1, 0.1, np.float32)
    dps = (rng.normal(0, 0.05, (N - 1, 3)) + 0.049 * G).astype(np.float32)
    dvs = (rng.normal(0, 0.05, (N - 1, 3)) + 0.981 * G).astype(np.float32)
    ok = np.ones(N - 1, bool)
    ok[3] = False
    return p, q, dt, dps, dvs, ok


def test_solve_gravity_velocity_matches_jax():
    """The damped least squares, the outlier rejection and the re-solves:
    gravity and velocities to 1e-3 (float32 normal equations of a system
    whose entries span 1e-2 .. 1e2), rms to 1e-3 relative."""
    args = _gravity_problem(8)
    g0 = np.array([0.1, -0.2, 9.8], np.float32)
    want = jgrav.solve_gravity_velocity(*(jnp.asarray(a) for a in args),
                                        jnp.asarray(g0), n_frames=8)
    got = gravity_init.solve_gravity_velocity(
        *(_t(a) for a in args[:5]), torch.from_numpy(args[5]), _t(g0),
        n_frames=8)
    np.testing.assert_allclose(got.gravity.numpy(), want.gravity, atol=1e-3)
    np.testing.assert_allclose(got.velocities.numpy(), want.velocities,
                               atol=1e-3)
    np.testing.assert_allclose(float(got.residual_rms),
                               float(want.residual_rms), rtol=1e-3)


def test_solve_bias_window_matches_jax():
    """Eight Gauss-Newton iterations over 4 anchored pairs (forward-mode
    Jacobians on both sides): biases to 1e-5, velocities to 1e-4 m/s,
    cost to 1e-3 relative."""
    W = 4
    rng = np.random.default_rng(9)
    cfg = JImuConfig()
    jpres = [_jax_pre(_window(seed=20 + i)) for i in range(W)]
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *jpres)
    states = [_state(rng, p_scale=0.5) for _ in range(W + 1)]
    pt = np.stack([s["t"] for s in states])
    pq = np.stack([s["q"] for s in states])
    pv = np.stack([s["v"] for s in states])
    valid = np.array([True, True, False, True])
    want = jbias.solve_bias_window(
        jnp.asarray(pt), jnp.asarray(pq), jnp.asarray(pv), stacked,
        jnp.asarray(valid), jnp.asarray(G), jnp.asarray(BA * 0.5),
        jnp.asarray(BG * 0.5), cfg)
    got = bias_estimator.solve_bias_window(
        _t(pt), _t(pq), _t(pv),
        interop.preintegration_from_numpy(_np(stacked), "cpu"),
        torch.from_numpy(valid), _t(G), _t(BA * 0.5), _t(BG * 0.5),
        ImuConfig())
    np.testing.assert_allclose(got.ba.numpy(), want.ba, atol=1e-5)
    np.testing.assert_allclose(got.bg.numpy(), want.bg, atol=1e-5)
    np.testing.assert_allclose(got.velocities.numpy(), want.velocities,
                               atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-3)


def test_nan_sample_propagates_without_raising():
    """A NaN IMU sample: the port yields non-finite values exactly where
    JAX does (preintegration, pre-solve, gravity solve), and nothing
    raises; the whitening matrix falls back to zeros on both sides."""
    w = _window(seed=10, nan_at=5)
    jp = _np(_jax_pre(w))
    tp = _port_pre(w)
    for f in jpre.Preintegration._fields:
        assert np.array_equal(np.isfinite(getattr(tp, f).numpy()),
                              np.isfinite(getattr(jp, f))), f
    assert not np.isfinite(jp.delta_p).all()
    np.testing.assert_array_equal(preintegration.sqrt_information(tp).numpy(),
                                  np.asarray(jpre.sqrt_information(
                                      jax.tree.map(jnp.asarray, jp))))
    si = _state(np.random.default_rng(11))
    want = jfactor.imu_presolve(jax.tree.map(jnp.asarray, jp), _jstate(si),
                                jnp.asarray(G))
    got = imu_factor.imu_presolve(tp, _tstate(si), _t(G))
    for a, b in ((got.pose.t, want.pose.t), (got.pose.q, want.pose.q),
                 (got.v, want.v)):
        assert np.array_equal(np.isfinite(a.numpy()), np.isfinite(b))
    args = list(_gravity_problem(12))
    args[3] = args[3].copy()
    args[3][:, 0] = np.nan                          # every pair poisoned
    args[5] = np.ones(7, bool)
    g0 = np.array([0.0, 0.0, 9.81], np.float32)
    want = jgrav.solve_gravity_velocity(*(jnp.asarray(a) for a in args),
                                        jnp.asarray(g0), n_frames=8)
    got = gravity_init.solve_gravity_velocity(
        *(_t(a) for a in args[:5]), torch.from_numpy(args[5]), _t(g0),
        n_frames=8)
    assert not np.isfinite(np.asarray(want.gravity)).all()
    assert np.array_equal(np.isfinite(got.gravity.numpy()),
                          np.isfinite(want.gravity))
    assert np.array_equal(np.isfinite(got.velocities.numpy()),
                          np.isfinite(want.velocities))


def test_config_carries_every_imu_field():
    """The port's ImuConfig has every field and default of the JAX one."""
    want = {f.name: f.default for f in dataclasses.fields(JImuConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ImuConfig)}
    assert got == want
