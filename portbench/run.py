"""One run of one benchmark cell:

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from ``BENCHMARK.json`` (``portbench.spec``), checks for
the cards it asks for, runs its driver (set-up, warm-up, the measured
window, the output check), and prints the result as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics, or with ``--trace 1`` the per-layer ones),
``device`` (with ``busy_s`` and ``window_s`` when traced), ``breakdown``
when traced, and last ``checks``: each number compared with its limit.
The same numbers close standard error, after the host's threads, cores
and affinity.

Host threads are fixed (``THREADS``) before torch loads. The run exits
with code 1 and prints no result when the cards are missing, and when
JAX, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

__all__ = ["main", "THREADS", "FORBIDDEN", "forbidden_modules",
           "result_line"]

THREADS = 4
FORBIDDEN = ("jax", "jaxlib", "flax", "empanada_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _host():
    aff = sorted(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else None
    return {"threads": THREADS, "cpu_count": os.cpu_count(),
            "affinity": aff}


def result_line(cell, out, trace, device_info):
    """The last line's object from a driver's result ``out``."""
    from portbench.spec import load_reader

    metrics = {}
    if trace:
        ctx = dict(out["ctx"])
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device_info)}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = out["checks"]
    return line


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(sys.argv[1:] if argv is None else argv)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    import torch

    from portbench import check
    from portbench.spec import Cell, load_benchmark, load_driver

    torch.set_num_threads(THREADS)
    cell = Cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    driver = load_driver(cell.traffic["kind"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 1
    print(f"portbench: host {_host()}", file=sys.stderr)
    print(f"portbench: detail {out['where']}", file=sys.stderr)
    out["correct"], out["checks"] = check.judge(out["numbers"],
                                                cell.limits["limits"])
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(cell, out, bool(args.trace), info)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
