"""Each cell on the card, briefly: correct, and its metrics present. Skips
without a card; on the card run with
`python -m pytest -o addopts="" -q portbench/tests/test_portbench_card.py`."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, card, capsys):
    from portbench import run

    assert run.main(["--workload", cell, "--seed", "2147483713",
                     "--seconds", "3", "--trace", "0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2
