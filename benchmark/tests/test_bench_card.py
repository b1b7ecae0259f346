"""On the card, at each one-card cell's own size: the program's first three
updates pass the cell's limits and the control (the reference with float8
products) fails them, on one seed each. Skips without a card."""

import json

import pytest

from benchmark import cells, compare
from benchmark.control import read_seeds
from benchmark.run import Cell

ONE_CARD = [w["name"] for w in cells.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("name", ONE_CARD)
def test_the_program_passes_and_the_control_fails(card, name):
    cell = Cell(name)
    got = {}
    for what in ("program", "control"):
        lines = []
        read_seeds(cell, what, [2 ** 31 + 97], emit=lines.append)
        got[what] = json.loads(lines[0])
    limits = cell.workload["limits"]
    keys = list(limits)
    ok, checks = compare.judge({k: got["program"][k] for k in keys}, limits)
    assert ok, checks
    ok, checks = compare.judge({k: got["control"][k] for k in keys}, limits)
    assert not ok, checks
