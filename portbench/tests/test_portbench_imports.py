"""Nothing under ``portbench/`` imports JAX or the JAX package, each
module's top-level name compared whole (``msf_loam_tpu_torch`` passes),
and nothing reads the JAX side's ``bench.py`` or ``BENCH_*.json``."""

import ast
import glob
import os

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "msf_loam_tpu"}
FILES = sorted(glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                         recursive=True))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    if os.sep + "tests" + os.sep not in path:   # what a run executes
        with open(path) as f:
            text = f.read()
        assert "BENCH_" not in text and "bench.py" not in text


REF = [p for p in FILES if os.sep + "ref" + os.sep in p]


@pytest.mark.parametrize("path", REF, ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_imports_nothing_of_the_program(path):
    """The plain reference stands alone: plain torch, numpy and its own
    modules, nothing of the port."""
    mods = [m for m in imported(path) if m != "__future__"]
    assert all(m.split(".")[0] in {"torch", "numpy", "typing", "math",
                                   "dataclasses", "contextlib", "portbench"}
               for m in mods), mods
    assert all(m.startswith("portbench.ref") or m == "portbench.ref"
               for m in mods if m.startswith("portbench")), mods


def test_the_rule_compares_whole_names():
    assert "msf_loam_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "msf_loam_tpu.ops".split(".")[0] in FORBIDDEN
