"""Shared helpers of the benchmark's tests. They run on the CPU at tiny
sizes; the one test that needs the card carries the `cuda` marker and skips
without one (decided inside the `card` fixture)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs a cell on the card")
    return "cuda"


def bench() -> dict:
    """BENCHMARK.json with the held-out cells of `held_out.json` added: the
    cells whose harness is kept and tested while the card's benchmark
    leaves them out."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    held = json.loads((Path(__file__).parent / "held_out.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        b[key] = b[key] + held[key]
    for m in b["end_to_end"]:
        if m["name"] in held["also_reports"]:
            m["workloads"] = m["workloads"] + held["also_reports"][m["name"]]
    return b


def tiny(cell: str) -> dict:
    """Overrides that shrink a cell to what the CPU runs in seconds: K=16,
    4096 samples (8192 for the posteriors, the least length that takes the
    cell's chained route), short windows on both sides, two recordings. The
    decode streams its windows, two a launch, as the cell's does."""
    entry = {"sort": "sort", "train": "train", "confidence": "confidence"}[
        cell.split(".")[1]]
    args = {"sort": {"L": 1024, "H": 64, "streaming": True,
                     "blocks_per_call": 2, "transfer": "dense",
                     "repair": True},
            "train": {"n_init": 4, "nsteps": 2}, "confidence": {}}[entry]
    return {"bench": bench(),
            "config": {"K": 16, "recording_samples": 4096},
            "traffic": {"pool": 2, "check_recordings": 1,
                        "args": args, "reference": {"L": 1024, "H": 256},
                        "samples": {"sort": "recording", "train": 4096,
                                    "confidence": 8192}[entry]}}


def run_tiny(cell, capsys, *, seconds=0.5, trace=0, seed=2147483711):
    """Runs the harness on the CPU; returns (exit code, result or None,
    standard error)."""
    from portbench import run

    capsys.readouterr()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device="cpu",
                  overrides=tiny(cell))
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err
