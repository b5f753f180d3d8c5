"""The control of each cell's comparison, at a size a test run holds: the
reference put in the program's place in bfloat16 (the precision below the
configurations' float32) has to come out not correct against the float64
reference, on every seed tried. `control.py` runs the same at the cells'
own sizes on the card."""

from __future__ import annotations

import pytest

from conftest import bench, tiny

CELLS = ["n2.sort", "n2.train", "n2.confidence", "n3.sort"]


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_is_not_correct(cell, capsys):
    """The decode and the posteriors at K=16 on 2^14 samples with the
    cells' own reference windows; training at the tiny size of the other
    tests."""
    from portbench import control

    small = (tiny(cell) if cell.endswith("train") else
             {"bench": bench(), "config": {"K": 16},
              "traffic": {"samples": 16384}})
    lines = control.main(["--workload", cell, "--seeds", "21", "22", "23"],
                         device="cpu", overrides=small)
    assert len(lines) == 3
    assert all(line["fails"] for line in lines)


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_training_faults_are_not_correct(fault, capsys):
    from portbench import control

    lines = control.main(["--workload", "n2.train", "--fault", fault,
                          "--seeds", "21", "22"], device="cpu",
                         overrides=tiny("n2.train"))
    assert all(line["fails"] for line in lines)
