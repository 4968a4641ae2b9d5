"""Where a volume cell's device idle time goes, named by the program's
spans (``empanada_torch.utils.profiling``):

    python3 -m portbench.spans --workload mitonet_slab --seed <n> --seconds 48

runs the cell's set-up and window as ``drivers/volume.py`` does (no
output check), under the device trace (``portbench.trace.Tracer``) and
with the program's span recorder on, and prints one JSON line. Before
the tracer closes, the dispatching thread's spans join the harness's, so
``reduce_events`` names each of the longest idle gaps by the program
span open when it began. Per volume (the mean over the window's
volumes):

- ``idle_s``: the window's device idle seconds by the innermost span
  open on the dispatching thread (``idle_by_span``; ``window`` where
  none is);
- ``span_s``: seconds by span name, every thread;
- ``off_cpu_s``: each span's wall time less its thread's CPU time, self
  time only (its children's taken out), by name;
- ``metrics``: the shares of the idle time in ``infer.load_wait``,
  ``infer.dispatch``, ``infer.handoff`` and outside the forward
  (``infer.join``, ``infer.consensus``, ``infer.fill``, ``infer.setup``),
  in %; ``handoff_wait_s`` and ``match_s``, the seconds of those spans;
  ``lock_wait_s``, the off-CPU self seconds of the work spans.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading

WORK = ("infer.load", "infer.dispatch", "infer.decode", "infer.match",
        "infer.backward", "infer.track", "infer.filter", "infer.consensus")
OUTSIDE_FORWARD = ("infer.join", "infer.consensus", "infer.fill",
                   "infer.setup")

__all__ = ["idle_by_span", "merged", "idle_intervals", "self_off_cpu",
           "per_volume", "main", "WORK", "OUTSIDE_FORWARD"]


def merged(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def idle_intervals(busy, w0, w1):
    """The parts of [w0, w1) that no interval of ``busy`` covers."""
    out, t = [], w0
    for s, e in merged((max(s, w0), min(e, w1)) for s, e in busy
                       if min(e, w1) > max(s, w0)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if w1 > t:
        out.append((t, w1))
    return out


def _pieces(spans):
    """(start, end, name) in time order: where the innermost open span
    of one thread's nested spans stays the same."""
    pieces, stack, t = [], [], None

    def emit(upto):
        if stack and upto > t:
            pieces.append((t, upto, stack[-1][0]))

    def close():
        nonlocal t
        end = stack[-1][2]
        emit(end)
        t = max(t, end)
        stack.pop()

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            close()
        emit(s)
        t = s
        stack.append((name, s, e))
    while stack:
        close()
    return pieces


def idle_by_span(idle, spans, thread, outside="window"):
    """Seconds of the idle intervals ``idle`` ((start_ns, end_ns),
    sorted, disjoint) by the innermost of ``spans`` (records with
    ``name``, ``thread``, ``start_ns``, ``end_ns``) open on ``thread``
    at each moment; ``outside`` gets the time in no span. Spans of other
    threads are ignored."""
    pieces = _pieces([(s.name, s.start_ns, s.end_ns) for s in spans
                      if s.thread == thread])
    out, i = {}, 0
    for a, b in idle:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        inside, j = 0, i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] = out.get(pieces[j][2], 0) + hi - lo
                inside += hi - lo
            j += 1
        if b - a > inside:
            out[outside] = out.get(outside, 0) + (b - a - inside)
    return {k: v / 1e9 for k, v in out.items()}


def self_off_cpu(spans):
    """{name: seconds}: each span's wall time less its thread's CPU time,
    less the same of the spans directly inside it."""
    child = {}
    for s in spans:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0) + \
                (s.end_ns - s.start_ns - s.cpu_ns)
    out = {}
    for s in spans:
        off = s.end_ns - s.start_ns - s.cpu_ns - child.get(s.id, 0)
        out[s.name] = out.get(s.name, 0) + off
    return {k: v / 1e9 for k, v in out.items()}


def per_volume(idle_s, spans, volumes):
    """The numbers of the module's docstring, per volume, from the
    window's idle seconds by span and its recorded spans."""
    span_s = {}
    for s in spans:
        span_s[s.name] = span_s.get(s.name, 0) + (s.end_ns - s.start_ns)
    span_s = {k: v / 1e9 / volumes for k, v in span_s.items()}
    off = {k: v / volumes for k, v in self_off_cpu(spans).items()}
    idle = {k: v / volumes for k, v in idle_s.items()}
    total = sum(idle.values())

    def share(*names):
        return 100.0 * sum(idle.get(n, 0.0) for n in names) / total \
            if total > 0 else None

    metrics = {
        "idle_load_share.infer": share("infer.load_wait"),
        "idle_dispatch_share.infer": share("infer.dispatch"),
        "idle_handoff_share.infer": share("infer.handoff"),
        "idle_outside_forward_share.infer": share(*OUTSIDE_FORWARD),
        "handoff_wait_s.infer": span_s.get("infer.handoff", 0.0),
        "match_s.infer": span_s.get("infer.match", 0.0),
        "lock_wait_s.infer": sum(off.get(n, 0.0) for n in WORK),
    }
    return {"idle_s": idle, "span_s": span_s, "off_cpu_s": off,
            "metrics": metrics}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench.run import THREADS

    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    import numpy as np
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.utils import profiling
    from portbench import gen
    from portbench.drivers import volume as vd
    from portbench.spec import Cell, load_benchmark
    from portbench.trace import WINDOW, Tracer

    torch.set_num_threads(THREADS)
    cell = Cell(load_benchmark(), args.workload)
    if cell.traffic["kind"] != "volume" or not torch.cuda.is_available():
        print(f"portbench.spans: {cell.name} needs a volume cell and a "
              f"CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    s = vd.settings(cell.traffic)
    model = vd.program_model(cell.config, vd.bench_weights(cell.config),
                             device)
    volume, _ = gen.em_volume(cell.traffic["volume"], args.seed)
    kw = vd.program_kwargs(s, device)
    run_inference3d(model, np.ascontiguousarray(
        volume[:cell.traffic["warm_slices"]]), **kw)
    vd.sync(device)
    gc.collect()
    gc.freeze()

    class KeepingTracer(Tracer):
        """Keeps the device's (start_ns, end_ns) intervals it reduces."""

        def __exit__(self, *exc):
            prof = self.prof
            out = super().__exit__(*exc)
            if prof is not None and exc[0] is None:
                cpu = torch.autograd.DeviceType.CPU
                self.ops = [
                    (e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() != cpu and not e.is_user_annotation()]
            return out

    me = threading.get_ident()
    with KeepingTracer(True) as tracer:
        with profiling.recording() as spans:
            with tracer.span(WINDOW):
                n, window_s, _, _ = vd.window(model, volume, kw,
                                              args.seconds, tracer)
        tracer.spans += [(x.name, x.start_ns, x.end_ns) for x in spans
                         if x.thread == me]
    gc.unfreeze()
    tr = tracer.result
    w0, w1 = next((a, b) for name, a, b in tracer.spans if name == WINDOW)
    idle = idle_intervals(tracer.ops, w0, w1)
    out = per_volume(idle_by_span(idle, spans, me, WINDOW), spans, n)
    metrics = out.pop("metrics")
    line = {"workload": cell.name, "seed": args.seed, "volumes": n,
            "window_s": window_s, "busy_s": tr["busy_s"],
            "idle_per_volume_s": sum(out["idle_s"].values()),
            "metrics": metrics,
            "shares_sum": sum(v for k, v in metrics.items()
                              if k.startswith("idle_")),
            "counters": {k: v / n for k, v in spans.counters.items()},
            **out, "idle_gaps": tr["idle_gaps"],
            "device": torch.cuda.get_device_name(device)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
