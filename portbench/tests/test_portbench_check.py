"""The output check: a sound run passes its limits; the timed path
broken underneath (the state left unchanged, half of each batch left
out) and the control (the reference in float8) fail them. CPU, at a
size a test run holds; the harness's look for a card is skipped by
calling the driver directly."""

import time

import pytest

from portbench import check, gen
from portbench.drivers import train

SEED = 2**31 + 99


def _run(cell, faults=None):
    out = train.run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                    faults=faults)
    return check.judge(out["numbers"], cell.limits["limits"])


def test_sound_run_is_correct(tiny):
    correct, checks = _run(tiny("mitonet"))
    assert correct, checks


@pytest.mark.parametrize("fault", [{"unchanged": True},
                                   {"half_batch": True}])
def test_broken_step_is_not_correct(tiny, fault):
    correct, checks = _run(tiny("mitonet"), train.Faults(**fault))
    assert not correct, checks


def test_control_is_not_correct(tiny):
    cell = tiny("mitonet")
    rec = train.recipe(cell.config, cell.traffic)
    pool = gen.training_pool(cell.traffic,
                             rec["DATASET"]["norms"], SEED, "cpu")
    steps = cell.traffic["check_steps"]
    ref = train.reference_steps(cell.config, rec, cell.traffic, pool, SEED,
                                "cpu", steps)
    fp8 = train.reference_steps(cell.config, rec, cell.traffic, pool, SEED,
                                "cpu", steps, precision="fp8")
    numbers, _ = check.train_numbers(fp8, ref)
    correct, checks = check.judge(numbers, cell.limits["limits"])
    assert not correct, checks
