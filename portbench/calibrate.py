"""Readings that the output check's limits are set from, on the card at
the cell's own size (the benchmark's runs do not run this):

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

The driver of the cell's traffic kind makes the readings (its
``readings``; ``portbench.spec``). For each seed of ``--seeds``, the
program against the plain reference (the lower readings): a training
cell's first steps, an inference cell's answer for the seed's volume.
For each seed of ``--control-seeds``, the control (the reference
computed in float8) and planted faults against the reference (the upper
readings): the half-batch fault of a training cell (the reference on the
first half of each batch's rows), the altered answers of an inference
cell (every second instance left out; every second instance merged into
the one before it). One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench.spec import Cell, load_benchmark, load_driver

__all__ = ["readings", "main"]


def readings(cell, seeds, control_seeds, device, emit, witness_seeds=()):
    """The readings of the driver of ``cell``'s traffic kind."""
    load_driver(cell.traffic["kind"], cell.base).readings(
        cell, seeds, control_seeds, device, emit, witness_seeds)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="",
                   help="inference cells: seeds on which the program also "
                        "runs in float32")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    cell = Cell(load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        rec["workload"] = cell.name
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        readings(cell, seeds, control, device, emit,
                 {int(x) for x in args.witness_seeds.split(",") if x})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
