"""The control of each cell comes out as not correct: the reference put
in the program's place and computed in fp8 (the step below the
configurations' bfloat16), and the cell's other controls, fail at least
one of the cell's limits. At a size a CPU test holds; the readings at the
cells' own sizes on the card are in PERF.md."""

from __future__ import annotations

import pytest

from flowbench import harness
from flowbench.tests.conftest import cell as get_cell, tiny

CASES = [("pwc-stream-sintel", "fp8"), ("pwc-stream-sintel", "stale"),
         ("raft-stream-sintel", "fp8"), ("raft-stream-sintel", "stale"),
         ("pwc-train-devgen", "fp8"), ("pwc-train-devgen", "half_batch")]


@pytest.mark.parametrize("name,variant", CASES)
def test_control_fails_a_limit(name, variant):
    cell = tiny(get_cell(name))
    got = harness.driver(cell).control(cell, 2 ** 31 + 3, "cpu", variant)
    assert set(cell.limits) <= set(got)
    assert any(got[k] > lim for k, lim in cell.limits.items()), got
