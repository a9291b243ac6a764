"""On the card (marked `cuda`, skipped elsewhere): each cell's control, the
reference with its decoder one precision lower, fails the cell's limit at
the cell's own size, while the program on the same seed passes it."""

import pytest

from benchmark.control import default_calls, readings
from benchmark.core.cell import Cell
from benchmark.tests.helpers import CELLS, REPO


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_the_limit(name, card):
    cell = Cell.load(name, REPO / "BENCHMARK.json")
    lim = cell.limits["max_gap"]
    r = readings(cell, 2**33 + 5, default_calls(cell), [lim["control"]], card)
    assert r["program"] <= lim["limit"] < r[f"control_{lim['control']}"]
