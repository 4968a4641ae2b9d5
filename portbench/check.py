"""The numbers that decide ``correct``, and their comparison with the
cell's limits.

A training cell compares the program's first steps with the plain
reference's on the same weights, batches and points:

- ``loss``: the largest relative gap of a step's loss;
- ``grad``: the median leaf's gap between the norms of its first
  gradient (the program's read from its optimizer's state after one
  step), against the larger of the reference leaf's norm and the median
  leaf's, over the leaves whose reference gradient is not zero (the
  worst leaf's gap is printed beside it: it is the rounding noise of
  small leaves whose gradients cancel, and swings from seed to seed);
- ``change``: the worst leaf's gap between the norms of its change over
  the steps, leaving out the leaves whose first reference gradient is
  under a thousandth of the median leaf's (they move by round-off
  alone); the median leaf is taken over the leaves whose reference
  gradient is not zero.
"""

from __future__ import annotations

import statistics
import sys

__all__ = ["leaf_gaps", "train_numbers", "judge", "ZERO_GRAD"]

ZERO_GRAD = 1e-3


def leaf_gaps(prog, ref, keep):
    """{leaf: |prog - ref| / max(ref, median ref)} over the leaves
    ``keep``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keep}


def train_numbers(prog, ref):
    """The three numbers of ``prog`` against ``ref`` (each as
    ``reference.train.run_steps`` returns it), and what the worst leaves
    read."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    nonzero = sorted(k for k, g in ref["grad"].items() if g > 0)
    med = statistics.median(ref["grad"][k] for k in nonzero)
    moving = [k for k in nonzero if ref["grad"][k] >= ZERO_GRAD * med]
    grad = leaf_gaps(prog["grad"], ref["grad"], nonzero)
    change = leaf_gaps(prog["change"], ref["change"], moving)
    worst_grad = max(grad, key=grad.get)
    worst_change = max(change, key=change.get)
    return ({"loss": loss, "grad": statistics.median(grad.values()),
             "change": change[worst_change]},
            {"worst_grad": [worst_grad, grad[worst_grad]],
             "change": worst_change,
             "left_out": len(ref["grad"]) - len(moving)})


def judge(numbers, limits, stream=sys.stderr):
    """(correct, checks): each number that ``limits`` names beside its
    limit (a number missing reads NaN and fails); prints one line each,
    the last lines of ``stream``."""
    checks = {name: {"value": numbers.get(name, float("nan")),
                     "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=stream)
    return correct, checks
