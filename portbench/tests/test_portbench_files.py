"""Every configuration, traffic mix and metric of ``BENCHMARK.json`` is
found by name and parsed, and the file keeps the benchmark's contract."""

import json
import os
import re

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_found_and_parsed(cfg):
    from portbench import pool
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    with open(os.path.join(ROOT, cfg["file"])) as f:
        body = json.load(f)
    assert body["name"] == cfg["name"]
    for key in cfg["reduced"]:
        assert key in body and key in body["reduced"]
    from msf_loam_tpu_torch.config import MsfLoamConfig
    MsfLoamConfig.from_dict(body["slam"])
    st = pool.drive_states(body)
    assert st["p"].shape == (body["frames"], 3)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    from portbench import run as bench
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    c = bench.Cell(cell["name"])
    assert c.traffic["mode"] in ("stream", "fleet")
    from portbench import check
    limits = c.traffic["check"]["limits"]
    # a number whose sound and control readings do not separate has no
    # limit; every cell holds its mapped poses and their finiteness
    assert set(limits) <= set(check.NUMBERS) and limits["not_finite"] == 0
    assert {"pose_gap_m", "pose_gap_median_m"} & set(limits)
    assert all(v >= 0 for v in limits.values())
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        mod = c.reader(m["name"])
        assert mod.UNIT == m["unit"] and callable(mod.read)
    for m in c.per_layer:
        assert m["moves"] in e2e


def test_metric_entries():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_no_card_exits_without_a_result(capsys):
    """Without the CUDA devices a cell asks for, the run prints no result
    and exits with a code other than 0 (this machine has no card)."""
    import torch

    from portbench import run as bench
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench.main(["--workload", "kitti_hdl64.stream", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err
