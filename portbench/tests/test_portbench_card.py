"""On the card, at the cells' own sizes: the program passes the cell's
limits, and the control (the reference in float8) and the planted faults
that the numbers compared can see fail them. Marked ``cuda``; skips
without a card (``python -m pytest portbench/tests -m cuda`` on a
machine with one)."""

import pytest

from portbench import check
from portbench.calibrate import readings
from portbench.spec import Cell, load_benchmark

BENCH = load_benchmark()
# readings that have to fail the limits (``merge_pairs`` is read for the
# record: no compared number holds instance identity)
FAIL = {"control", "drop_half", "half_batch"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_program_passes_control_and_fault_fail(card, workload):
    cell = Cell(BENCH, workload)
    got = []
    readings(cell, [2**31 + 5], {2**31 + 5}, card, got.append)
    limits = cell.limits["limits"]
    for r in got:
        passed = check.judge(r["numbers"], limits)[0]
        if r["kind"] in FAIL or r["kind"] == "program":
            assert passed == (r["kind"] == "program"), r
    assert {r["kind"] for r in got} >= {"program", "control"}
