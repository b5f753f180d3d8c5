"""The harness end to end on the CPU at tiny sizes: the result line's
schema, the import check, and the runs that must print no result."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny

CELLS = ["n2.sort", "n2.train", "n2.confidence"]
E2E = {"n2.sort": {"setup_s", "sort_samples_per_s"},
       "n2.train": {"setup_s", "train_samples_per_s", "recording_p95_s"},
       "n2.confidence": {"setup_s", "posterior_samples_per_s",
                         "recording_p95_s"}}


def check_schema(res):
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and res["failed"] == 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, capsys):
    rc, res, err = run_tiny(cell, capsys)
    assert rc == 0
    check_schema(res)
    assert res["correct"] is True
    assert set(res["metrics"]) == E2E[cell]
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_traced_result_line(capsys):
    rc, res, _ = run_tiny("n2.sort", capsys, seconds=8.0, trace=1)
    assert rc == 0
    check_schema(res)
    assert res["correct"] is True
    assert {"decode_ll_ms.sort", "overlap_save_ms.sort"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    from portbench import run

    before = run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "hmmspikesorter_tpux", sys)
    monkeypatch.setitem(sys.modules, "jaxy.core", sys)
    assert run.forbidden_loaded() == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in run.forbidden_loaded()


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "hmmspikesorter_torch", "hmmspikesorter_tpu", "jax",
                    "jaxlib", "flax"), (path.name, n)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.hmm, portbench.reference.train, "
            "portbench.reference.posterior; "
            "print(sorted(m.split('.')[0] for m in sys.modules "
            "if m.split('.')[0].startswith(('hmmspike', 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_that_loads_jax_prints_no_result(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    rc, res, err = run_tiny("n2.sort", capsys)
    assert rc != 0 and res is None
    assert "jax" in err


def harness_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "n2.sort",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, env=harness_env(), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "n2.sort",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, env=harness_env(), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    json.loads((tmp_path / "BENCHMARK.json").read_text())
