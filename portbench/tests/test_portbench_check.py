"""The check against the plain reference: it passes the port's CPU path
(the kernels' plain versions) at a small size, where the reference
(``portbench/ref``, which imports nothing of the port) agrees with it;
it fails a run whose timed path is broken underneath, once for each fault
a cell can have; and on the card it fails the control, the reference run
in TF32 in the program's place."""

import pytest
import torch

from conftest import tiny_cell
from portbench import check
from portbench import run as bench
from portbench.ref import frame as ref

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977
CELLS = [("kitti_hdl64", "street_tour_stream"),
         ("kitti_hdl64", "street_tour_fleet_B256")]


@pytest.mark.parametrize("config,traffic", CELLS, ids=["stream", "fleet"])
def test_port_cpu_path_passes_the_check(config, traffic, tmp_path):
    """The reference in float32 agrees with the port's CPU path: bit for
    bit in the single pipeline, to the batched solve's rounding in the
    fleet; every frame is compared and the counts are equal."""
    cell = tiny_cell(config, traffic, tmp_path)
    cell.traffic["check"].pop("compare_frames")
    got = {}
    res, lines = bench.measure(cell, SEED, 3.0, False, CPU, numbers=got)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(got) == set(check.NUMBERS)
    assert got["map_count_gap"] == 0 and got["not_finite"] == 0
    most = 0.0 if traffic.endswith("stream") else 1e-5
    assert got["step_gap_m"] <= most and got["pose_gap_m"] <= most
    assert list(res)[-1] == "checks"


def test_fleet_lanes_start_apart(tmp_path, monkeypatch):
    """The fleet's lanes start at frames drawn from the seed, so they do
    different work; the check samples one lane from each half."""
    from portbench import drive
    cell = tiny_cell("kitti_hdl64", "street_tour_fleet_B256", tmp_path,
                     lanes=8)
    seen = {}
    real = drive.Fleet.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        seen["offsets"] = self.offsets.tolist()
        seen["keep"] = self.keep
    monkeypatch.setattr(drive.Fleet, "__init__", init)
    res, lines = bench.measure(cell, SEED, 1.0, False, CPU)
    assert res["correct"], lines
    assert len(set(seen["offsets"])) > 1
    assert seen["keep"][0] < 4 <= seen["keep"][1]
    assert check.sample_lanes(SEED, 256, 2) == check.sample_lanes(SEED, 256, 2)


def _state_unchanged(monkeypatch):
    """The frame runs, but hands back the maps and poses it was given."""
    from msf_loam_tpu_torch.slam import pipeline
    real = pipeline.fused_frame_step_from_image

    def frozen(cfg, cmap, smap, prev, img, t, c2l, odom, o2m, first):
        out = real(cfg, cmap, smap, prev, img, t, c2l, odom, o2m, first)
        return (cmap, smap, c2l, odom, o2m, o2m.compose(odom)) + out[6:]
    monkeypatch.setattr(pipeline, "fused_frame_step_from_image", frozen)


def _half_batch_left_out(monkeypatch):
    """Only the first half of the lanes is computed; the second half gets
    the first half's results."""
    from msf_loam_tpu_torch.core.pointcloud import RingImage
    from msf_loam_tpu_torch.slam import batch_pipeline
    real = batch_pipeline.run_batch

    def half(cfg, state, imgs):
        B = imgs.xyz.shape[1]
        src = torch.arange(B) % (B // 2)
        return real(cfg, state, RingImage(*(a[:, src] for a in imgs)))
    monkeypatch.setattr(batch_pipeline, "run_batch", half)


def _lane0_broadcast(monkeypatch):
    """Lane 0's answer is handed out for every lane."""
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.slam import batch_pipeline
    real = batch_pipeline.run_batch

    def bcast(p):
        return Pose(p.t[..., :1, :].expand_as(p.t).clone(),
                    p.q[..., :1, :].expand_as(p.q).clone())

    def one(cfg, state, imgs):
        state, poses = real(cfg, state, imgs)
        state = state._replace(pose_c2l=bcast(state.pose_c2l),
                               pose_odom=bcast(state.pose_odom),
                               pose_o2m=bcast(state.pose_o2m))
        return state, bcast(poses)
    monkeypatch.setattr(batch_pipeline, "run_batch", one)


def _answer_altered(monkeypatch):
    """One scan's mapped pose moved by 5 cm where the frame hands it out."""
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline
    real = SlamPipeline.process_ring_image

    def altered(self, img, t):
        res = real(self, img, t)
        if self.frame_idx == 10:
            self.pose_map = Pose(self.pose_map.t
                                 + torch.tensor([0.05, 0.0, 0.0]),
                                 self.pose_map.q)
        return res
    monkeypatch.setattr(SlamPipeline, "process_ring_image", altered)


def _lane_answer_altered(monkeypatch):
    """One lane's mapped pose moved by 5 cm in every frame where the
    batched frame hands it out."""
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.slam import batch_pipeline
    real = batch_pipeline.run_batch

    def altered(cfg, state, imgs):
        state, poses = real(cfg, state, imgs)
        t = poses.t.clone()
        t[:, -1, 0] += 0.05
        return state, Pose(t, poses.q)
    monkeypatch.setattr(batch_pipeline, "run_batch", altered)


@pytest.mark.parametrize("traffic,fault", [
    ("street_tour_stream", _state_unchanged),
    ("street_tour_stream", _answer_altered),
    ("street_tour_fleet_B256", _half_batch_left_out),
    ("street_tour_fleet_B256", _lane0_broadcast),
    ("street_tour_fleet_B256", _lane_answer_altered)],
    ids=["stream-state-unchanged", "stream-altered", "fleet-half-batch",
         "fleet-lane0-broadcast", "fleet-lane-altered"])
def test_broken_timed_path_is_not_correct(traffic, fault, tmp_path,
                                          monkeypatch):
    # every frame compared: the run compares a sample drawn from the seed
    cell = tiny_cell("kitti_hdl64", traffic, tmp_path)
    cell.traffic["check"].pop("compare_frames")
    if traffic.endswith("B256"):
        # the last lane is in the sample of the second half
        monkeypatch.setattr(check, "sample_lanes",
                            lambda seed, lanes, n: [0, lanes - 1])
    fault(monkeypatch)
    res, lines = bench.measure(cell, SEED, 3.0, False, CPU)
    assert not res["correct"], lines


def test_not_finite_pose_fails(tmp_path, monkeypatch):
    from msf_loam_tpu_torch.core.se3 import Pose
    from msf_loam_tpu_torch.slam.pipeline import SlamPipeline
    real = SlamPipeline.process_ring_image

    def nan(self, img, t):
        res = real(self, img, t)
        if self.frame_idx == 10:
            self.pose_map = Pose(self.pose_map.t * float("nan"),
                                 self.pose_map.q)
        return res
    monkeypatch.setattr(SlamPipeline, "process_ring_image", nan)
    cell = tiny_cell("kitti_hdl64", "street_tour_stream", tmp_path)
    res, lines = bench.measure(cell, SEED, 3.0, False, CPU)
    assert not res["correct"] and res["failed"] == 1, lines


def test_own_states_read_nothing_against_themselves(tmp_path):
    """The reference run in the program's place at the check's own
    precision reads 0: the control's gap is its precision's alone."""
    cell = tiny_cell("kitti_hdl64", "street_tour_stream", tmp_path)
    got = {}

    def keep(sessions):
        got["s"] = check.own_states(sessions, cell.config["slam"], CPU,
                                    False, torch.float32, tf32=False)
        return got["s"]
    res, lines = bench.measure(cell, SEED, 2.0, False, CPU, sessions=keep)
    assert res["correct"], lines
    # (the rotation gap is worked out in float64 from float32 quaternions)
    assert all(v["value"] <= 1e-12 for v in res["checks"].values()), lines


@pytest.mark.card
def test_control_is_not_correct(card, tmp_path):
    """The control, the reference in TF32 in the program's place, fails
    the check on the card (TF32 exists only there)."""
    for traffic in ("street_tour_stream", "street_tour_fleet_B256"):
        cell = tiny_cell("kitti_hdl64", traffic, tmp_path)
        batched = traffic.endswith("B256")

        def control(sessions):
            return check.own_states(sessions, cell.config["slam"], card,
                                    batched, torch.float32, tf32=True)
        res, lines = bench.measure(cell, SEED, 3.0, False, card,
                                   sessions=control)
        assert not res["correct"], lines


def test_precision_is_restored():
    before = torch.get_default_dtype()
    with ref.precision(torch.float64, tf32=True):
        assert torch.get_default_dtype() == torch.float64
    assert torch.get_default_dtype() == before
    assert not torch.backends.cuda.matmul.allow_tf32
