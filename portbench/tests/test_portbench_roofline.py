"""The roofline arithmetic gives the bounds of ``PERF.md``'s kernel table
(section 6: H100 SXM, 3.35 TB/s and 67 TFLOP/s float32)."""

import pytest

from portbench import roofline


def ms(work):
    return roofline.bound_s(*work) * 1e3


def test_pick_rounds_64_ring_bound():
    # features.run_pick_rounds at the default FeatureConfig
    assert ms(roofline.pick_work(64, 2048, 2, 18, 6, 4, 6)) == \
        pytest.approx(0.00068, abs=5e-6)


@pytest.mark.parametrize("N,M,K,want", [(768, 7680, 0, 0.00132),
                                        (1536, 8192, 16, 0.00282)])
def test_odo_corr_64_ring_bounds(N, M, K, want):
    assert ms(roofline.odo_work(N, M, K)) == pytest.approx(want, abs=5e-6)


def test_select_fit_street_bounds():
    # the mapping pair: line (4096 rows x 256) + plane2 (4096 x 256)
    line = roofline.select_work(4096, 256, 5, "line")
    plane = roofline.select_work(4096, 256, 5, "plane2")
    pair = (line[0] + plane[0], line[1] + plane[1])
    assert ms(pair) == pytest.approx(0.00766, abs=5e-5)
    # the odometry plane fit: 1536 queries x 8 candidates, k = 8
    assert ms(roofline.select_work(1536, 8, 8, "plane")) == \
        pytest.approx(0.0000770, abs=2e-6)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 134e12) == pytest.approx(2.0)


@pytest.mark.parametrize("kernel", sorted(roofline.Recorder.ENTRY_POINTS))
def test_wrapped_entry_points_exist(kernel):
    """Each kernel's entry point that the recorder wraps is in the
    program, and wrapping it leaves nothing missing."""
    import importlib
    mod_name, attr = roofline.Recorder.ENTRY_POINTS[kernel]
    assert callable(getattr(importlib.import_module(mod_name), attr))
    rec = roofline.Recorder()
    with rec.active():
        pass
    assert rec.missing == {}


def test_kernel_out_of_sight_is_refused(monkeypatch):
    """A kernel that ran while its entry point could not be wrapped makes
    its roofline fail loudly, not read None."""
    from types import SimpleNamespace
    monkeypatch.setitem(roofline.Recorder.ENTRY_POINTS, "odo_corr",
                        ("msf_loam_tpu_torch.ops.odo_corr", "renamed"))
    rec = roofline.Recorder()
    with rec.active():
        pass
    assert "odo_corr" in rec.missing
    ran = SimpleNamespace(device_s=lambda name: 1e-3)
    with pytest.raises(RuntimeError, match="out of the yardstick's sight"):
        roofline.share(SimpleNamespace(recorder=rec, stretch=ran),
                       "odo_corr")
    idle = SimpleNamespace(device_s=lambda name: 0.0)
    assert roofline.share(SimpleNamespace(recorder=rec, stretch=idle),
                          "odo_corr") is None


def test_kernel_reached_by_another_path_is_refused():
    """A kernel with device time in the stretch and no call noted at its
    wrapped entry point (the program reached it by another path) fails
    loudly too."""
    from types import SimpleNamespace
    rec = roofline.Recorder()
    ran = SimpleNamespace(device_s=lambda name: 1e-3)
    with pytest.raises(RuntimeError, match="no call of it was noted"):
        roofline.share(SimpleNamespace(recorder=rec, stretch=ran),
                       "select_fit")
