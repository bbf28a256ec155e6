"""Shared pieces of the benchmark's own tests (CPU; the ``card`` marker
names the tests that need the H100 and skip without it)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs the CUDA card; skips without it")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's card)")
    return torch.device("cuda", 0)


def tiny_cell(config: str, traffic, tmp_path, **traffic_over):
    """A cell cut to a size the CPU runs in seconds: 16 rings of 600
    points, a 30-frame drive, small maps; its pool is cast under
    ``tmp_path``. ``traffic`` names a traffic file or is the mix itself."""
    from portbench import pool
    from portbench import run as bench
    pool.CACHE = str(tmp_path / "cache")
    c = object.__new__(bench.Cell)
    c.name, c.chips, c.root = f"{config}.tiny", 1, ROOT
    with open(os.path.join(ROOT, "portbench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    if isinstance(traffic, dict):
        tr = json.loads(json.dumps(traffic))
    else:
        with open(os.path.join(ROOT, "portbench", "traffic",
                               traffic + ".json")) as f:
            tr = json.load(f)
    cfg["sensor"].update(pts_per_ring=600, rings=16)
    cfg["world"]["n_blocks"] = cfg["route"]["n_blocks"] = 2
    cfg["frames"] = 30
    m = cfg["slam"].setdefault("mapping", {})
    m.update(map_table_size=4096, max_query_points=1024)
    cfg["slam"]["features"]["max_less_flat"] = 2048
    tr.update(warmup_frames=min(tr["warmup_frames"], 8), trace_frames=2)
    if tr["mode"] == "fleet":
        tr["lanes"] = 4
    tr.update(traffic_over)
    c.config, c.traffic = cfg, tr
    c.end_to_end = [{"name": "setup_s", "unit": "s"}]
    c.per_layer = [{"name": "wall_ms_per_scan.stream", "unit": "ms"}]
    return c
