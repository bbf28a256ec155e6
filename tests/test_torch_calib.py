"""The port's LiDAR-IMU extrinsic calibration (``imu/extrinsic_calib.py``
and ``apps/calib_lidar_imu``) against the JAX package's, on the CPU.

The right-singular vector the solve takes is defined only up to sign;
both packages fix it by w >= 0 on every iteration, so q is held to 1e-5
as it stands, not up to sign. One small JAX program is compiled
(``calibrate_extrinsic_rotation`` at one pair count)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msf_loam_tpu.apps import calib_lidar_imu as jcli
from msf_loam_tpu.imu import extrinsic_calib as jcal
from msf_loam_tpu_torch import proto as tproto
from msf_loam_tpu_torch.apps import calib_lidar_imu as tcli
from msf_loam_tpu_torch.core import se3 as tse3
from msf_loam_tpu_torch.dataio import artifacts as tart
from msf_loam_tpu_torch.imu import extrinsic_calib as tcal

torch.set_num_threads(1)
N_PAIRS = 24


def _pairs(rng, q_ric, noise, n_outliers, n_invalid):
    """(dq_lidar, dq_imu, valid) with dq_lidar = q_ric dq_imu q_ric^-1 plus
    noise, some pairs replaced by random rotations, some marked invalid."""
    theta = rng.normal(size=(N_PAIRS, 3)).astype(np.float32) * 0.3
    dq_imu = tse3.quat_exp(torch.from_numpy(theta))
    qr = torch.as_tensor(q_ric, dtype=torch.float32)
    dq_lidar = tse3.quat_multiply(tse3.quat_multiply(qr, dq_imu),
                                  tse3.quat_conjugate(qr))
    dq_lidar = tse3.quat_normalize(dq_lidar + noise * torch.from_numpy(
        rng.normal(size=(N_PAIRS, 4)).astype(np.float32)))
    if n_outliers:
        dq_lidar[:n_outliers] = tse3.quat_exp(torch.from_numpy(
            rng.normal(size=(n_outliers, 3)).astype(np.float32)))
    valid = np.ones(N_PAIRS, bool)
    valid[N_PAIRS - n_invalid:] = False
    return dq_lidar.numpy(), dq_imu.numpy(), valid


@pytest.mark.parametrize("case", ["clean", "outliers_and_invalid",
                                  "negative_w_truth", "too_few_valid"])
def test_calibrate_extrinsic_rotation_matches_jax(case):
    seed, q_ric, noise, n_out, n_inv = {
        "clean": (0, [0.96, 0.15, -0.1, 0.2], 1e-4, 0, 0),
        "outliers_and_invalid": (1, [0.9, -0.3, 0.2, 0.25], 2e-3, 3, 4),
        # the truth's w < 0: the result is its negation under the sign rule
        "negative_w_truth": (2, [-0.7, 0.5, 0.4, -0.3], 1e-3, 0, 2),
        "too_few_valid": (3, [0.96, 0.15, -0.1, 0.2], 1e-3, 0, N_PAIRS - 8),
    }[case]
    rng = np.random.default_rng(seed)
    q_ric = np.asarray(q_ric) / np.linalg.norm(q_ric)
    dql, dqi, valid = _pairs(rng, q_ric, noise, n_out, n_inv)
    want = jcal.calibrate_extrinsic_rotation(
        jnp.asarray(dql), jnp.asarray(dqi), jnp.asarray(valid))
    got = tcal.calibrate_extrinsic_rotation(
        torch.from_numpy(dql), torch.from_numpy(dqi), torch.from_numpy(valid))
    np.testing.assert_allclose(got.q_ric.numpy(), np.asarray(want.q_ric),
                               rtol=0, atol=1e-5)
    assert float(got.q_ric[0]) >= 0
    np.testing.assert_allclose(float(got.singular_gate),
                               float(want.singular_gate), rtol=1e-4)
    assert bool(got.converged) == bool(want.converged)
    if case == "too_few_valid":
        assert not bool(got.converged)
    else:
        assert bool(got.converged)
        assert abs(float(got.q_ric.numpy() @ q_ric)) > 0.999


def test_integrate_gyro_rotation_matches_jax():
    rng = np.random.default_rng(3)
    gyr = rng.normal(size=(60, 3)).astype(np.float32)
    dts = rng.uniform(0.002, 0.006, 60).astype(np.float32)
    valid = rng.uniform(size=60) > 0.1
    want = jcal.integrate_gyro_rotation(jnp.asarray(gyr), jnp.asarray(dts),
                                        jnp.asarray(valid))
    got = tcal.integrate_gyro_rotation(torch.from_numpy(gyr),
                                       torch.from_numpy(dts),
                                       torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_calib_cli_matches_jax(tmp_path, capsys):
    """A trajectory + IMU record with a known extrinsic rotation, as npz
    and as pbstream: both CLIs recover it with the same output (the port's
    with ``--device cpu``; without CUDA its default device raises)."""
    rng = np.random.default_rng(5)
    q_ric = np.array([0.96, 0.15, -0.1, 0.2])
    q_ric /= np.linalg.norm(q_ric)
    n_frames, imu_hz, frame_dt = 40, 200, 0.1
    times = np.arange(n_frames) * frame_dt
    n_imu = (n_frames - 1) * imu_hz // 10
    k = np.arange(n_imu)
    gyr = np.stack([0.6 * np.sin(0.05 * k), 0.4 * np.cos(0.03 * k),
                    0.5 * np.sin(0.02 * k + 1)], axis=1)
    gyr = gyr + rng.normal(scale=0.01, size=gyr.shape)
    imu_times = k / imu_hz
    # IMU orientation by integrating the gyro; the lidar sees it
    # conjugated by q_ric (the hand-eye identity)
    dq = tse3.quat_exp(torch.as_tensor(gyr / imu_hz, dtype=torch.float64))
    q_imu = [torch.tensor([1.0, 0, 0, 0], dtype=torch.float64)]
    for j in range(n_imu):
        q_imu.append(tse3.quat_normalize(tse3.quat_multiply(q_imu[-1], dq[j])))
    qr = torch.as_tensor(q_ric)
    q_lidar = np.stack([tse3.quat_multiply(tse3.quat_multiply(
        qr, q_imu[min(int(round(i * frame_dt * imu_hz)), n_imu)]),
        tse3.quat_conjugate(qr)).numpy() for i in range(n_frames)])
    imu = {"times": imu_times, "angular_velocity": gyr,
           "linear_acceleration": np.zeros_like(gyr)}
    npz = str(tmp_path / "traj.npz")
    pbs = str(tmp_path / "trajectory.pbstream")
    tart.save_trajectory(npz, times, np.zeros((n_frames, 3)), q_lidar, imu=imu)
    tproto.write_pbstream(pbs, times, np.zeros((n_frames, 3)), q_lidar, imu)
    for path in (npz, pbs):
        outs = []
        for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
            assert main(["--trajectory", path] + extra) == 0
            outs.append(json.loads(capsys.readouterr().out.strip()))
        want, got = outs
        assert got["converged"] and want["converged"]
        assert got["n_pairs"] == want["n_pairs"] == 13
        np.testing.assert_allclose(got["q_ric_wxyz"], want["q_ric_wxyz"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["sigma_gate"], want["sigma_gate"],
                                   rtol=0, atol=2e-4)
        assert abs(np.asarray(got["q_ric_wxyz"]) @ q_ric) > 0.999
    if not torch.cuda.is_available():
        # the port's app runs on the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["--trajectory", npz])
