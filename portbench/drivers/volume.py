"""Inference cells: ``run_inference3d`` on the traffic's volume, each call
followed by ``fill_volume`` into an in-memory label array.

Set-up makes the bench MitoNet's weights (the fitted heads' seeded
backbone) and the volume from the seed, builds the model in the
configuration's dtype, and warms every slice shape and block size of
the cell with one call on the volume's first ``warm_slices`` slices.
The window runs whole volumes back to back and closes with the first
that ends at or after ``seconds``; the rate is all their voxels over all
that time. After it, every volume's answer is held against the last
one's, the program is freed, and the plain reference segments the same
volume; the comparison decides ``correct``.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import gen
from portbench.drivers.train import Stamps, sync, state_shapes
from portbench.flops import model_flops
from portbench.reference import infer as ref_infer
from portbench.reference import models as ref_models
from portbench.spec import HERE
from portbench.trace import WINDOW, Tracer
from portbench.weights import bench_state

__all__ = ["settings", "bench_weights", "program_model", "run_volume",
           "window", "reference_answer", "volume_flops", "k1_bytes", "run",
           "readings", "drop_half", "merge_pairs"]


def settings(traffic):
    return dict(traffic["settings"])


def program_kwargs(s, device):
    """``run_inference3d``'s keywords for settings ``s``."""
    return dict(labels=[1], thing_list=[1], mode=s["mode"], qlen=s["qlen"],
                label_divisor=s["label_divisor"], seg_thr=s["seg_thr"],
                nms_thr=s["nms_thr"], nms_kernel=s["nms_kernel"],
                iou_thr=s["iou_thr"], ioa_thr=s["ioa_thr"],
                pixel_vote_thr=s["pixel_vote_thr"],
                cluster_iou_thr=s["cluster_iou_thr"],
                min_size=s["min_size"], min_span=s["min_span"],
                max_centers=s["max_centers"], block_size=s["block_size"],
                padding_factor=s["padding"], norms=s["norms"],
                progress=False, device=device)


def bench_weights(cfg):
    return bench_state(state_shapes(cfg), HERE / "configs" / cfg["heads"],
                       cfg["recipe"]["MODEL"]["num_fc"])


def program_model(cfg, state, device):
    from empanada_torch.models import create_model

    m = dict(cfg["recipe"]["MODEL"])
    arch, dtype = m.pop("arch"), m.pop("dtype")
    model = create_model(arch, device=device, dtype=dtype, **m)
    model.load_state_dict(state)
    return model.eval()


def drop_half(instances):
    """A planted fault (calibration and tests only): every second
    instance of an answer left out."""
    return {k: v for i, (k, v) in enumerate(instances.items()) if i % 2 == 0}


def merge_pairs(instances):
    """A planted fault (calibration and tests only): every second
    instance of an answer merged into the one before it, so that the
    foreground stays as it was and the instances do not."""
    items = list(instances.items())
    out = {}
    for i in range(0, len(items), 2):
        group = [v for _, v in items[i:i + 2]]
        out[items[i][0]] = {
            "starts": np.concatenate([np.asarray(v["starts"], np.int64)
                                      for v in group]),
            "runs": np.concatenate([np.asarray(v["runs"], np.int64)
                                    for v in group])}
    return out


def run_volume(model, volume, kw, tracer):
    """One volume: (filled uint32 labels, instances, stats, fill
    seconds)."""
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.inference.patterns import fill_volume

    stats = {}
    with tracer.span("run_inference3d"):
        consensus = run_inference3d(model, volume, stats=stats, **kw)
    instances = consensus[1].instances
    t0 = time.perf_counter()
    with tracer.span("fill_volume"):
        out = np.zeros(volume.shape, np.uint32)
        fill_volume(out, instances)
    return out, instances, stats, time.perf_counter() - t0


def window(model, volume, kw, seconds, tracer, clock=time.perf_counter):
    """Volumes until one ends at or after ``seconds``; returns (volumes,
    seconds, the last answer, every volume's instances, stats and fill
    seconds)."""
    sync(kw["device"])
    t0 = clock()
    runs = []
    while True:
        out, instances, stats, fill_s = run_volume(model, volume, kw, tracer)
        runs.append((instances, stats, fill_s))
        if clock() - t0 >= seconds:
            break
    sync(kw["device"])
    return len(runs), clock() - t0, out, runs


def same_instances(a, b):
    if a.keys() != b.keys():
        return False
    return all(np.array_equal(np.asarray(a[k]["starts"]),
                              np.asarray(b[k]["starts"]))
               and np.array_equal(np.asarray(a[k]["runs"]),
                                  np.asarray(b[k]["runs"])) for k in a)


def reference_answer(cfg, volume, s, device, precision="fp32"):
    """The plain reference's label volume for ``volume`` and its per-axis
    foreground probabilities."""
    return _reference(cfg, bench_weights(cfg), volume, s, device, precision)


def _reference(cfg, state, volume, s, device, precision="fp32"):
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = ref_models.build(cfg, device)
        model.load_state_dict(state)
        model.eval()
        ref_models.set_precision(model, precision)
        return ref_infer.segment(model, volume, s, device)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _axes(volume, s):
    return [0] if s["mode"] == "stack" else [0, 1, 2]


def _padded(hw, f):
    return tuple(-(-x // f) * f for x in hw)


def volume_flops(cfg, volume, s):
    """Forward operations of one volume: each slice of each axis at its
    padded size, counted on the plain reference (meta device)."""
    model = ref_models.build(cfg, "meta").eval()
    total = 0
    for axis in _axes(volume, s):
        ph, pw = _padded(tuple(np.delete(volume.shape, axis)),
                         s["padding"])
        x = torch.empty((2, 1, ph, pw), device="meta")
        per_two = model_flops(_InferOnly(model), x)
        total += per_two // 2 * volume.shape[axis]
    return total


class _InferOnly(torch.nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model.infer(x)


def k1_bytes(volume, s):
    """Bytes the grouping kernel must read and write for one volume: per
    slice its centers (int32 pairs) and their flags, the 1/4-resolution
    offsets (two float32) and the ids it writes (int32)."""
    total = 0
    k = s["max_centers"]
    for axis in _axes(volume, s):
        ph, pw = _padded(tuple(np.delete(volume.shape, axis)), s["padding"])
        cells = (ph // 4) * (pw // 4)
        total += volume.shape[axis] * (k * 9 + cells * 12)
    return total


def run(cell, seed, seconds, trace, device, t_start):
    """One run of the cell: set-up, window, output check."""
    from empanada_torch.ops import group

    cfg, traffic = cell.config, cell.traffic
    s = settings(traffic)
    stamp = Stamps()
    state = bench_weights(cfg)
    model = program_model(cfg, state, device)
    del state
    stamp("model")
    volume, _ = gen.em_volume(traffic["volume"], seed)
    stamp("volume")
    kw = program_kwargs(s, device)
    from empanada_torch.cli.infer3d import run_inference3d

    run_inference3d(model, np.ascontiguousarray(
        volume[:traffic["warm_slices"]]), **kw)
    stamp("warm-up")
    sync(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    launches = group.LAUNCHES["group_pixels"]
    with Tracer(trace) as tracer:
        with tracer.span(WINDOW):
            n, window_s, answer, runs = window(model, volume, kw, seconds,
                                               tracer)
    launches = group.LAUNCHES["group_pixels"] - launches
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.unfreeze()
    failed = sum(not same_instances(r[0], runs[-1][0]) for r in runs)
    stats = [r[1] for r in runs]
    fill_s = sum(r[2] for r in runs)
    del model, runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    stamp = Stamps()
    want, probs = reference_answer(cfg, volume, s, device)
    stamp("reference")
    numbers = ref_infer.compare_labels(answer, want, probs=probs,
                                       thr=s["seg_thr"])
    print(f"portbench: instances {len(np.unique(answer)) - 1} (reference "
          f"{int(want.max())}); volumes that differ from the last {failed}; "
          f"numbers {numbers}", file=sys.stderr)
    # only the traced run's per-layer metrics read the operation count
    flops = volume_flops(cfg, volume, s) if trace else None
    tr = tracer.result
    k1_s = None
    if tr is not None:
        k1_s = sum(t for name, t in tr["op_seconds"].items()
                   if "group_pixels" in name) or None
    return {
        "numbers": numbers,
        "where": {"launches": launches},
        "attempted": n, "failed": failed,
        "end_to_end": {"volume_mvox_per_s": n * volume.size / 1e6 / window_s,
                       "setup_s": setup_s},
        "ctx": {"volumes": n, "window_s": window_s, "trace": tr,
                "dtype": cfg["recipe"]["MODEL"].get("dtype"),
                "flops_per_volume": flops,
                "k1_bytes_per_volume": k1_bytes(volume, s),
                "k1_device_s": k1_s,
                "forward_s": sum(a["forward_seconds"] for st in stats
                                 for a in st["axes"].values()) / n,
                "host_tail_s": sum(a["seconds"] - a["forward_seconds"]
                                   for st in stats
                                   for a in st["axes"].values()) / n,
                "consensus_s": sum(st.get("consensus_seconds", 0.0)
                                   for st in stats) / n,
                "fill_s": fill_s / n},
        "memory_peak_bytes": peak,
    }


def readings(cell, seeds, control_seeds, device, emit, witness_seeds=()):
    """Calibration readings (``portbench.calibrate``): for each seed the
    program's answer for the seed's volume against the plain reference's
    (``program``); on the control seeds also the reference in float8
    (``control``) and the program's instances altered (``drop_half``,
    ``merge_pairs``) against it; on the witness seeds the program in
    float32 (``program_float32``)."""
    from empanada_torch.inference.patterns import fill_volume

    cfg, s = cell.config, settings(cell.traffic)
    model = program_model(cfg, bench_weights(cfg), device)
    kw = program_kwargs(s, device)

    def numbers(got, want_probs):
        return ref_infer.compare_labels(got, want_probs[0],
                                        probs=want_probs[1],
                                        thr=s["seg_thr"])

    for seed in seeds:
        t0 = time.perf_counter()
        vol, _ = gen.em_volume(cell.traffic["volume"], seed)
        out, inst, _, _ = run_volume(model, vol, kw, Tracer(False))
        t1 = time.perf_counter()
        ref = reference_answer(cfg, vol, s, device)
        emit({"kind": "program", "seed": seed,
              "numbers": numbers(out, ref), "instances": len(inst),
              "ref_instances": int(ref[0].max()), "program_s": t1 - t0,
              "reference_s": time.perf_counter() - t1})
        if seed in control_seeds:
            fp8 = reference_answer(cfg, vol, s, device, "fp8")[0]
            emit({"kind": "control", "seed": seed,
                  "numbers": numbers(fp8, ref), "instances": int(fp8.max())})
            for fault in (drop_half, merge_pairs):
                bad = np.zeros(vol.shape, np.uint32)
                fill_volume(bad, fault(inst))
                emit({"kind": fault.__name__, "seed": seed,
                      "numbers": numbers(bad, ref)})
        if seed in witness_seeds:
            # the program in float32: what the reference and the program
            # differ by apart from the configuration's bfloat16
            cfg32 = dict(cfg, recipe=dict(cfg["recipe"], MODEL=dict(
                cfg["recipe"]["MODEL"], dtype="float32")))
            m32 = program_model(cfg32, bench_weights(cfg), device)
            out32, _, _, _ = run_volume(m32, vol, kw, Tracer(False))
            del m32
            emit({"kind": "program_float32", "seed": seed,
                  "numbers": numbers(out32, ref)})
        gc.collect()
        torch.cuda.empty_cache()
