"""Readings that the output check's limits are set from, on the card at
the cell's own size (the benchmark's runs do not run this):

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

For each seed of ``--seeds``, the program against the plain reference
(the lower readings): a training cell's first steps, an inference
cell's answer for the seed's volume. For each seed of
``--control-seeds``, the control (the reference computed in float8)
and planted faults against the reference (the upper readings): the
half-batch fault of a training cell (the reference on the first half
of each batch's rows), the altered answers of an inference cell (every
second instance left out; every second instance merged into the one
before it). One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import numpy as np
import torch

from portbench import check
from portbench.drivers import train
from portbench.spec import Cell, load_benchmark

__all__ = ["readings", "main"]


def readings(cell, seeds, control_seeds, device, emit, witness_seeds=()):
    if cell.traffic["kind"] == "volume":
        return volume_readings(cell, seeds, control_seeds, device, emit,
                               witness_seeds)
    traffic = cell.traffic
    steps = traffic["check_steps"]
    for seed in seeds:
        t0 = time.perf_counter()
        state = train.setup(cell, seed, device)
        pool, prog, rec = state["pool"], state["program"], state["recipe"]
        del state
        gc.collect()
        torch.cuda.empty_cache()
        ref = train.reference_steps(cell.config, rec, traffic, pool, seed,
                                    device, steps)
        numbers, where = check.train_numbers(prog, ref)
        emit({"kind": "program", "seed": seed, "numbers": numbers,
              "where": where, "loss": prog["loss"], "ref_loss": ref["loss"],
              "seconds": time.perf_counter() - t0})
        if seed in control_seeds:
            half = slice(0, traffic["batch"] // 2)
            for kind, kw in (("control", {"precision": "fp8"}),
                             ("half_batch", {"rows": half})):
                other = train.reference_steps(cell.config, rec, traffic,
                                              pool, seed, device, steps,
                                              **kw)
                numbers, where = check.train_numbers(other, ref)
                emit({"kind": kind, "seed": seed, "numbers": numbers,
                      "where": where, "loss": other["loss"]})
        del pool
        gc.collect()
        torch.cuda.empty_cache()


def volume_readings(cell, seeds, control_seeds, device, emit,
                    witness_seeds=()):
    from portbench import gen
    from portbench.drivers import volume as vd
    from portbench.reference.infer import compare_labels
    from portbench.trace import Tracer

    cfg, s = cell.config, vd.settings(cell.traffic)
    model = vd.program_model(cfg, vd.bench_weights(cfg), device)
    kw = vd.program_kwargs(s, device)

    def numbers(got, want_probs):
        return compare_labels(got, want_probs[0], probs=want_probs[1],
                              thr=s["seg_thr"])

    for seed in seeds:
        t0 = time.perf_counter()
        vol, _ = gen.em_volume(cell.traffic["volume"], seed)
        out, inst, _, _ = vd.run_volume(model, vol, kw, Tracer(False))
        t1 = time.perf_counter()
        ref = vd.reference_answer(cfg, vol, s, device)
        emit({"kind": "program", "seed": seed,
              "numbers": numbers(out, ref), "instances": len(inst),
              "ref_instances": int(ref[0].max()), "program_s": t1 - t0,
              "reference_s": time.perf_counter() - t1})
        if seed in control_seeds:
            fp8 = vd.reference_answer(cfg, vol, s, device, "fp8")[0]
            emit({"kind": "control", "seed": seed,
                  "numbers": numbers(fp8, ref), "instances": int(fp8.max())})
            from empanada_torch.inference.patterns import fill_volume

            for fault in (vd.drop_half, vd.merge_pairs):
                bad = np.zeros(vol.shape, np.uint32)
                fill_volume(bad, fault(inst))
                emit({"kind": fault.__name__, "seed": seed,
                      "numbers": numbers(bad, ref)})
        if seed in witness_seeds:
            # the program in float32: what the reference and the program
            # differ by apart from the configuration's bfloat16
            cfg32 = dict(cfg, recipe=dict(cfg["recipe"], MODEL=dict(
                cfg["recipe"]["MODEL"], dtype="float32")))
            m32 = vd.program_model(cfg32, vd.bench_weights(cfg), device)
            out32, _, _, _ = vd.run_volume(m32, vol, kw, Tracer(False))
            del m32
            emit({"kind": "program_float32", "seed": seed,
                  "numbers": numbers(out32, ref)})
        gc.collect()
        torch.cuda.empty_cache()


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
