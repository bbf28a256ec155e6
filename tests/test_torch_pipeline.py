"""The port's lidar-only frame against the JAX package over a 3-frame
drive, plus the port's package rules.

Each frame starts both implementations from the same state (the JAX
pipeline's maps, poses and previous scan, carried across by
``msf_loam_tpu_torch.interop``), so the comparison is one frame at a time
and differences cannot add up. The JAX side runs its kernel path
(fused_corr / fused_select "on", Pallas in interpret mode; XLA pick
rounds, bit-equal to its Pallas kernel); the port runs the plain versions
of its kernels on the CPU. Per frame, the odometry result (match_scan2scan
against the JAX kernel path, fused_corr="on") and the mapped pose
(match_scan2map_core against fused_select="on") are both held to 1e-4."""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

import msf_loam_tpu_torch
from msf_loam_tpu.config import FeatureConfig as JFeatureConfig
from msf_loam_tpu.config import MappingConfig as JMappingConfig
from msf_loam_tpu.config import MsfLoamConfig as JMsfLoamConfig
from msf_loam_tpu.config import OdometryConfig as JOdometryConfig
from msf_loam_tpu.dataio import preprocess as jpre
from msf_loam_tpu.dataio import synthetic as jsyn
from msf_loam_tpu.slam.pipeline import SlamPipeline as JSlamPipeline
from msf_loam_tpu_torch import interop
from msf_loam_tpu_torch.config import (FeatureConfig, MappingConfig,
                                       MsfLoamConfig)
from msf_loam_tpu_torch.slam.pipeline import SlamPipeline

FEAT = dict(max_points_per_ring=512, max_less_flat=1024)
MAP = dict(map_table_size=1 << 12, max_query_points=256,
           max_corner_query_points=128, gather_groups=128,
           map_evict_period=2, map_evict_radius=12.0)

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)


def _copy(tree):
    """numpy copies of a JAX state (the JAX frame donates its maps)."""
    return jax.tree.map(np.array, tree)


def test_three_frame_drive_matches_jax_frame_by_frame():
    jcfg = JMsfLoamConfig(features=JFeatureConfig(fused_picks="off", **FEAT),
                          odometry=JOdometryConfig(fused_corr="on"),
                          mapping=JMappingConfig(fused_select="on", **MAP))
    cfg = MsfLoamConfig(features=FeatureConfig(**FEAT),
                        mapping=MappingConfig(**MAP))
    jp = JSlamPipeline(jcfg)
    tp = SlamPipeline(cfg, device="cpu")
    world = jsyn.World.corridor(seed=0, size=12.0)
    for i in range(3):
        yaw = 0.03 * i
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0.0],
                      [np.sin(yaw), np.cos(yaw), 0.0], [0.0, 0.0, 1.0]])
        xyz, ring = jsyn.simulate_scan(world, np.array([0.2 * i, 0.04 * i, 0.0]),
                                       R, n_rings=8, pts_per_ring=512,
                                       noise=0.004, seed=i)
        img = jpre.preprocess_scan(xyz, ring, jcfg.features, num_rings=8)
        # start the port from the JAX pipeline's state before this frame
        tp.corner_map = interop.map_from_numpy(_copy(jp.corner_map), "cpu")
        tp.surf_map = interop.map_from_numpy(_copy(jp.surf_map), "cpu")
        for name in ("pose_curr2last", "pose_odom", "pose_odom2map"):
            setattr(tp, name, interop.pose_from_numpy(
                _copy(getattr(jp, name)), "cpu"))
        tp.prev_scan = None if jp.prev_scan is None else \
            interop.scan_features_from_numpy(_copy(jp.prev_scan), "cpu")
        tp.frame_idx = jp.frame_idx
        got = tp.process_ring_image(interop.ring_image_from_numpy(img, "cpu"),
                                    0.1 * i)
        want = jp.process_ring_image(img, 0.1 * i)
        # one frame of float32 Gauss-Newton (odometry, then mapping) whose
        # sums run in another order: 1e-4 m / 1e-4 rad. pose_curr2last is
        # the frame's match_scan2scan result, map_pose its
        # match_scan2map_core result.
        for a, b in ((tp.pose_curr2last, jp.pose_curr2last),
                     (got.map_pose, want.map_pose),
                     (got.odom_pose, want.odom_pose)):
            np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-4)
            np.testing.assert_allclose(a.q.numpy(), np.asarray(b.q), atol=1e-4)
        assert abs(got.n_correspondences - want.n_correspondences) <= 2
        assert got.ok and want.ok
        # inserted points hash from poses equal to ~1e-5 m: a point can only
        # change leaf voxel at a boundary, so counts agree to 0.5%
        for tm, jm in ((tp.corner_map, jp.corner_map),
                       (tp.surf_map, jp.surf_map)):
            nt, nj = int(tm.count.sum()), int(np.asarray(jm.count).sum())
            assert abs(nt - nj) <= 0.005 * nj + 1, (nt, nj)
    assert float(got.map_pose.t[0]) > 0.3              # the drive moved
    assert int(tp.surf_map.count.sum()) > 100


def test_package_imports_neither_jax_nor_the_jax_package():
    """AST check over every module of the port and the chip smoke run: no
    ``jax`` and no ``msf_loam_tpu`` (``msf_loam_tpu_torch`` is the port
    itself)."""
    root = pathlib.Path(msf_loam_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py")) + [root.parent / "chip_smoke.py"]
    assert len(files) >= 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "msf_loam_tpu"), \
                    f"{path.relative_to(root.parent)} imports {name}"


def test_default_device_raises_without_cuda():
    """Entry points run on the card unless the caller asks for the CPU:
    without CUDA a default pipeline raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for CPU machines")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamPipeline(MsfLoamConfig())
