"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and metric found by its name."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT, bench

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
HELD = bench()


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time
    n = 24
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"])
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["name"] not in seen
        seen.add(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in HELD["workloads"]])
def test_cell_found_by_name(cell):
    """Every cell, the held-out ones too, finds its files by name."""
    from portbench.run import (BENCH as BENCH_DIR, cell_metrics, cell_spec,
                               reader_path)

    w, cfg, traffic, limits = cell_spec(HELD, cell)
    assert (BENCH_DIR / "entries" / f"{traffic['entry']}.py").is_file()
    e2e = cell_metrics(HELD, cell, 0)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    for m in e2e:
        assert reader_path("e2e", m["name"]).is_file()
    layers = cell_metrics(HELD, cell, 1)
    assert layers
    for m in layers:
        assert m["moves"] in names
        assert reader_path("layers", m["name"]).is_file()
    assert limits


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert set(cfg["reduced"]) <= set(data["reduced"])
    assert set(data["reduced"]) <= set(data)
    from portbench.reference.space import build

    assert build(data["N"], data["K"], data["overlaps"]).S == data["S"]


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
