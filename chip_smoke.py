#!/usr/bin/env python3
"""Build and drive the PyTorch port (empanada_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases (each prints its results; any
failure exits non-zero before the final line):

1. device: require CUDA; print the card's name and power limit;
2. build every hand-written kernel from ``empanada_torch/csrc`` (one
   nvcc per source, all started together) and print ``ptxas -v``;
3. each kernel against its plain PyTorch version on the card (exact
   integer equality) at the main path's shape and at the fine-boundary
   and dense shapes, then timings: the kernel's device time
   (torch.profiler), the wrapper's (CUDA events, host included), the
   plain version's and a library call's, beside the bounds;
4. the main path at full width: MitoNet (PanopticBiFPNPR on
   regnety_6p4gf) from a seeded init through
   ``run_inference3d(mode="stack")`` on a seeded uint8 volume, with the
   kernel launch counts read around that run; plus the full-width model
   forward on CUDA against the CPU on a small input;
5. content: a parameter-free synthetic model on an ellipsoid volume,
   CUDA vs CPU instance RLEs exactly equal and matching the ellipsoid.

The line before the last is the kernel table (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM (NVIDIA data sheet): HBM3 bandwidth, and float32 outside the
# tensor cores. Its 67 TFLOP/s counts an FMA as two operations; the
# grouping kernel is built without FMA (--fmad=false, rounded
# __fmul_rn / __fadd_rn), so each of its operations is one instruction at
# half that rate.
PEAK_BYTES = 3.35e12
PEAK_F32_INSTR = 33.5e12
# rounded f32 instructions per pixel-center pair of the grouping scan:
# 2 subtractions, 2 products, 1 sum, 1 compare, 1 select
OPS_PER_PAIR = 7

# grouping kernel shapes: B, grid H = W, K, step, valid centers per slice
GROUP_SHAPES = {
    "main": (8, 128, 256, 4.0, [256, 256, 40, 0, 256, 17, 200, 63]),
    "fine": (8, 512, 256, 1.0, [136, 120, 150, 136, 128, 144, 136, 140]),
    "dense": (8, 128, 512, 4.0, [400, 380, 420, 400, 512, 390, 410, 388]),
}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds a call of fn() on the card's clock (CUDA events
    around reps back-to-back calls: host launch cost included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(event):
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_ms(fn, reps, kernel=None):
    """Mean device milliseconds a call of fn() over reps back-to-back
    calls: the self device time that torch.profiler records for the
    kernels whose name contains ``kernel`` (every device event when None),
    divided by reps. The profiler can lose device records: a trace
    that does not hold all reps launches of ``kernel`` is taken again,
    up to 3 times. Fails when no trace is whole, or when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if not str(e.device_type).endswith("CUDA"):
                continue
            if kernel is not None and kernel not in e.key:
                continue
            total += device_us(e)
            count += e.count
        if kernel is None or count == reps:
            break
        print(f"profiler counted {count} launches of {kernel}, not {reps}: "
              f"tracing again")
    else:
        fail(f"profiler counted {count} launches of {kernel}, not {reps}, "
             f"in 3 traces")
    if total <= 0:
        fail(f"torch.profiler recorded no device time for "
             f"{kernel or 'the call'}")
    return total / 1e3 / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible device(s)")


def phase_build():
    from empanada_torch import cuda_build

    t0 = time.time()
    libs = cuda_build.build_all()
    print(f"built {len(libs)} kernel(s) in {time.time() - t0:.1f} s: "
          f"{', '.join(sorted(libs))}")


def group_inputs(rng, shape, kind, n_valid=None):
    """Seeded inputs for the grouping kernel at one of GROUP_SHAPES, on
    the card. ``n_valid[i]`` valid centers in slice i: a random subset on
    even slices, a valid prefix (as find_instance_centers gives) on odd
    ones. Offsets: "random" (normal, 12 px), "em" (each pixel points at
    its nearest valid center, plus normal noise of 1.5 px, as a trained
    model's do) or "special" (random, with NaN, +-inf and +-1e6 at a few
    pixels of every slice). Odd slices are quantized to half pixels,
    which puts many pixels on exact distance ties."""
    import torch

    from empanada_torch.ops import group

    b, h, k, step, default_valid = GROUP_SHAPES[shape]
    n_valid = default_valid if n_valid is None else n_valid
    centers = rng.integers(0, h, (b, k, 2)).astype(np.int32)
    valid = np.zeros((b, k), bool)
    for i, nv in enumerate(n_valid):
        valid[i, rng.permutation(k)[:nv] if i % 2 == 0 else slice(0, nv)] \
            = True
    noise = rng.standard_normal((b, h, h, 2)).astype(np.float32)
    c = torch.from_numpy(centers).cuda()
    v = torch.from_numpy(valid).cuda()
    if kind == "em":
        near = group.group_pixels_plain(c, v, torch.zeros((b, h, h, 2),
                                                          device="cuda"),
                                        step).long()
        target = torch.gather(
            c.float() * step, 1,
            (near - 1).clamp(min=0).reshape(b, h * h, 1).expand(-1, -1, 2))
        grid = torch.arange(h, dtype=torch.float32, device="cuda") * step
        loc = torch.stack(torch.broadcast_tensors(grid[:, None], grid[None]),
                          dim=-1)
        o = torch.from_numpy(noise * 1.5).cuda()
        o = torch.where(near[..., None] > 0,
                        target.reshape(b, h, h, 2) - loc + o, o)
    else:
        o = torch.from_numpy(noise * 12).cuda()
    o[1::2] = torch.round(o[1::2] * 2) / 2
    if kind == "special":
        flat = o.view(b, h * h, 2)
        values = [float("nan"), float("inf"), -float("inf"), 1e6, -1e6]
        for i in range(b):
            at = torch.from_numpy(rng.choice(h * h, 5, replace=False)).cuda()
            for j, val in enumerate(values):
                flat[i, at[j], (i + j) % 2] = val
    return c, v, o.contiguous()


def print_ptxas(label, log):
    for line in log.splitlines():
        if "ptxas info" in line and ("registers" in line or "spill" in line
                                     or "smem" in line):
            print(f"{label} {line.strip()}")


def group_check(c, v, o, step):
    """Kernel ids against plain ids; returns (pixels that differ,
    max |id difference|)."""
    from empanada_torch.ops import group

    got = group.group_pixels_batched(c, v, o, step)
    want = group.group_pixels_plain(c, v, o, step)
    return (int((got != want).sum()),
            int((got.long() - want.long()).abs().max()))


def group_timing(c, v, o, step):
    """One input set's numbers: device ms of the kernel (torch.profiler,
    200 launches), the wrapper's CUDA-event ms, the plain version's and
    the library yardstick's device ms, the bounds, and the tile counters
    with the time their kept pairs would take at the peak rate."""
    import torch

    from empanada_torch.ops import group

    b, h, w, _ = o.shape

    def kernel():
        return group.group_pixels_batched(c, v, o, step)

    def library():
        # yardstick only: one PyTorch call for the distances + argmin
        ys = torch.arange(h, device=o.device, dtype=torch.float32) * step
        xs = torch.arange(w, device=o.device, dtype=torch.float32) * step
        loc = torch.stack([ys[None, :, None] + o[..., 0],
                           xs[None, None, :] + o[..., 1]], dim=-1)
        d = torch.cdist(loc.reshape(b, h * w, 2), c.float() * step)
        return d.argmin(dim=2)

    reps, slow_reps = 200, max(3, 20 * 128 * 128 // (h * w))
    name = "group_pixels_kernel"
    row = {"ms": device_ms(kernel, reps, name)}
    row["wrapper_ms"] = cuda_ms(kernel, reps)
    row["plain_ms"] = device_ms(
        lambda: group.group_pixels_plain(c, v, o, step), slow_reps)
    row["library_ms"] = device_ms(library, slow_reps)
    # bound: each input read once and the ids written once, against the
    # one distance per pixel that any exact method computes (its winner's)
    nbytes = c.numel() * 4 + v.numel() + o.numel() * 4 + b * h * w * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = OPS_PER_PAIR * b * h * w / PEAK_F32_INSTR * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    valid_pairs = int(v.sum()) * h * w
    row["scan_bound_ms"] = OPS_PER_PAIR * valid_pairs / PEAK_F32_INSTR * 1e3
    # not a bound: the pairs this kernel's tiles kept (its own pruning)
    # at the peak rate
    stats = group.tile_stats(c, v, o, step)
    pairs = stats["pruned_pairs"] + stats["exhaustive_pairs"]
    row["kept_pairs_ms"] = OPS_PER_PAIR * pairs / PEAK_F32_INSTR * 1e3
    row["pairs_per_valid_pair"] = pairs / max(1, valid_pairs)
    row["tiles"] = stats
    return row


def phase_group_kernel():
    """group_pixels kernel vs its plain version, exact, at the main,
    fine and dense shapes over random-subset and prefix masks, random,
    EM-like and special offsets (NaN, +-inf, +-1e6) and, at main, the
    full / sparse / empty mixes at steps 1 and 4; then the timings.
    Returns the kernel's JSON row (launches filled in later)."""
    from empanada_torch import cuda_build

    print_ptxas("group_pixels", cuda_build.build_log("group_pixels"))
    rng = np.random.default_rng(0)
    b = GROUP_SHAPES["main"][0]
    cases = [("main", kind, None, step) for kind in ("random", "em",
                                                     "special")
             for step in (1.0, 4.0)]
    cases += [("main", "random", n_valid, step)
              for n_valid in ([256] * b, [40] * b, [0] * b)
              for step in (1.0, 4.0)]
    cases += [(shape, kind, None, GROUP_SHAPES[shape][3])
              for shape in ("fine", "dense")
              for kind in ("random", "em", "special")]
    worst = 0
    for shape, kind, n_valid, step in cases:
        c, v, o = group_inputs(rng, shape, kind, n_valid)
        label = (f"{shape}/{kind}/step {step:g}"
                 f"{'' if n_valid is None else f'/valid {n_valid[0]}'}")
        n_bad, err = group_check(c, v, o, step)
        worst = max(worst, err)
        if n_bad:
            fail(f"group_pixels kernel != plain ({label}): {n_bad} pixels "
                 f"differ")
    print(f"group_pixels: kernel == plain exactly over {len(cases)} cases "
          f"(shapes main, fine, dense; offsets random, EM-like, special; "
          f"random and prefix masks; steps 1, 4 at main)")

    shapes = {}
    for shape, (b, h, k, step, n_valid) in GROUP_SHAPES.items():
        for kind in ("random", "em"):
            c, v, o = group_inputs(np.random.default_rng(1), shape, kind)
            row = group_timing(c, v, o, step)
            shapes.setdefault(shape, {})[kind] = row
            print(f"group_pixels {shape} (B={b}, {h}x{h}, K={k}, "
                  f"{sum(n_valid)} valid, step {step:g}) {kind}: device "
                  f"{row['ms']:.5f} ms; wrapper {row['wrapper_ms']:.5f} ms, "
                  f"plain {row['plain_ms']:.4f} ms, cdist+argmin "
                  f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.6f} "
                  f"ms ({row['bound_by']}), exhaustive scan bound "
                  f"{row['scan_bound_ms']:.6f} ms, kept pairs "
                  f"{row['kept_pairs_ms']:.6f} ms; tiles {row['tiles']}")

    main = shapes["main"]["random"]
    return {
        "name": "group_pixels",
        "route": "cuda",
        "source": "empanada_torch/csrc/group_pixels.cu",
        "replaces": "empanada_tpu/ops/pallas_group.py:35",
        "launches": 0,
        "max_abs_err": worst,
        "ms": main["ms"],
        "wrapper_ms": main["wrapper_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "scan_bound_ms": main["scan_bound_ms"],
        "library_ms": main["library_ms"],
        "shapes": shapes,
    }


def em_like_volume(rng, d, h, w, n_blobs=40):
    """Seeded uint8 volume: noisy background with bright ellipsoids."""
    vol = rng.normal(110, 20, (d, h, w))
    zz, yy, xx = np.ogrid[:d, :h, :w]
    for _ in range(n_blobs):
        cz, cy, cx = rng.uniform(0, d), rng.uniform(0, h), rng.uniform(0, w)
        rz, ry, rx = rng.uniform(3, 8), rng.uniform(8, 30), rng.uniform(8, 30)
        inside = ((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 \
            + ((xx - cx) / rx) ** 2 <= 1
        vol = np.where(inside, 200.0, vol)
    return np.clip(vol, 0, 255).astype(np.uint8)


def phase_main_path():
    """Full-width MitoNet through run_inference3d(stack) on the card;
    returns the kernel launch counts of that run, the model and the
    volume."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.models import create_model
    from empanada_torch.ops import group

    model = create_model("PanopticBiFPNPR", encoder="regnety_6p4gf",
                         num_classes=1, device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"MitoNet (PanopticBiFPNPR, regnety_6p4gf): {n_params} parameters")

    # the full-width forward, CUDA vs CPU on a small input
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 128, 128))
                         .astype(np.float32))
    with torch.inference_mode():
        got = {k: v.float().cpu() for k, v in
               model(x.cuda(), interpolate_ins=False).items()}
        cpu_model = create_model("PanopticBiFPNPR", encoder="regnety_6p4gf",
                                 num_classes=1, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        want = cpu_model(x, interpolate_ins=False)
    shapes = {"sem_logits": (2, 1, 128, 128), "ctr_hmp": (2, 1, 32, 32),
              "offsets": (2, 2, 32, 32)}
    for key, shape in shapes.items():
        a, r = got[key], want[key]
        if tuple(a.shape) != shape or not torch.isfinite(a).all():
            fail(f"model output {key}: shape {tuple(a.shape)} (want "
                 f"{shape}) or non-finite values")
        rel = float((a - r).abs().max() / r.abs().max().clamp(min=1e-12))
        print(f"forward {key}: CUDA vs CPU max |diff| / max |ref| = "
              f"{rel:.2e}")
        if rel > 1e-3:
            fail(f"model output {key} on CUDA disagrees with the CPU "
                 f"({rel:.2e} > 1e-3 of max |value|)")
    del cpu_model

    norms = {"mean": 0.57, "std": 0.12}
    kwargs = dict(labels=[1], thing_list=[1], mode="stack", qlen=3,
                  label_divisor=20000, norms=norms, progress=False,
                  device="cuda", min_size=500, min_span=4)
    rng = np.random.default_rng(2)
    # warm-up on a short stack of the same slice shape (same block size)
    run_inference3d(model, em_like_volume(rng, 4, 512, 512, 10), **kwargs)
    vol = em_like_volume(rng, 16, 512, 512)

    torch.cuda.synchronize()
    group.reset_launches()
    stats = {}
    t0 = time.time()
    result = run_inference3d(model, vol, stats=stats, **kwargs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(group.LAUNCHES)

    if sorted(result) != [1] or result[1].shape3d != vol.shape:
        fail(f"main path returned {sorted(result)}")
    n_inst = len(result[1].instances)
    axis = stats["axes"]["xy"]
    print(f"main path: {vol.shape[0]} slices of {vol.shape[1]}x"
          f"{vol.shape[2]} in {seconds:.3f} s = "
          f"{vol.shape[0] / seconds:.2f} slices/s; "
          f"{axis['instances_matched']} matched 2D instances, {n_inst} 3D "
          f"instances, {axis['overflow_slices']} overflow slices; kernel "
          f"launches {launches}")
    if launches["group_pixels"] <= 0:
        fail("the main path never launched the group_pixels kernel")
    return launches, model, vol


def phase_breakdown(model, vol):
    """Where the main path's time goes (``--profile``): the engine alone
    (device pipeline + one packed copy per block, no host matching), the
    model forward and the postprocess of one block, and a torch.profiler
    trace of the engine pass (device busy time by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from empanada_torch.data import VolumeDataset
    from empanada_torch.inference.fused import FusedStackEngine

    engine = FusedStackEngine(
        model, None, [1], label_divisor=20000, median_kernel_size=3,
        nms_threshold=0.1, nms_kernel=3, confidence_thr=0.3, stuff_area=0,
        device_norms={"mean": 0.57, "std": 0.12}, pipeline_depth=8,
        device="cuda")
    dataset = VolumeDataset(vol)

    def engine_pass():
        for _, _, packed in engine.infer_blocks(dataset):
            np.asarray(packed)
        torch.cuda.synchronize()

    engine_pass()  # warm
    t0 = time.time()
    engine_pass()
    engine_s = time.time() - t0
    blocks = engine.last_dispatch_count
    print(f"breakdown: engine alone {engine_s:.3f} s for {vol.shape[0]} "
          f"slices in {blocks} blocks of 8 = "
          f"{vol.shape[0] / engine_s:.2f} slices/s")

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (8, 1, 512, 512))
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x, interpolate_ins=False), reps=5,
                         warmup=2)
        out = model(x, interpolate_ins=False)
        sem = torch.sigmoid(out["sem_logits"])
        ctr = out["ctr_hmp"][:, 0].contiguous()
        off = out["offsets"].permute(0, 2, 3, 1).contiguous()
        table = torch.tensor([False, True], device="cuda")
        post_ms = cuda_ms(lambda: engine._postprocess(
            sem, ctr, off, 2, 1, engine._auto_max_runs(512, 512),
            (512, 512), table), reps=5, warmup=2)
    print(f"breakdown: one block (8 x 512^2): model forward "
          f"{fwd_ms:.3f} ms, postprocess {post_ms:.3f} ms")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        engine_pass()
        wall_ms = (time.time() - t0) * 1e3

    # device-side entries only (kernels, copies): the aten ops that
    # launch them carry the same time again
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    print(f"breakdown: profiled engine pass {wall_ms:.1f} ms wall, device "
          f"busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for e in events[:12]:
        print(f"  {device_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")

    # the host half on its own (serial, one thread): run decode + CCL,
    # forward matching, backward matching, tracking and filters over the
    # engine's packed blocks, under cProfile
    import cProfile
    import pstats

    from empanada_torch.inference import patterns
    from empanada_torch.inference.rle import runs_to_rle_seg, unpack_packed_runs

    blocks = [(z, pan.shape[-2:], np.asarray(packed))
              for z, pan, packed in engine.infer_blocks(dataset)]

    def host_half():
        matchers = patterns.create_matchers([1], 20000, 0.25, 0.25)
        stack = []
        for z_indices, pad_shape, arr in blocks:
            for j, z in enumerate(z_indices):
                if z is None:
                    continue
                s, e, v, shape = unpack_packed_runs(arr[j], pad_shape)
                seg = runs_to_rle_seg(s, e, v, shape, [1], 20000, [1])
                stack.append(patterns.apply_matchers(seg, matchers))
        trackers = patterns.create_axis_trackers({"xy": 0}, [1], 20000,
                                                 vol.shape)
        patterns.finish_axis(stack, matchers, trackers["xy"], len(stack),
                             500, 4)

    t0 = time.time()
    host_half()
    host_s = time.time() - t0
    n_runs = sum(int(arr[j, 0, 0]) for z, _, arr in blocks
                 for j, zz in enumerate(z) if zz is not None)
    print(f"breakdown: host half alone {host_s:.3f} s for "
          f"{vol.shape[0]} slices ({n_runs} foreground runs)")
    prof = cProfile.Profile()
    prof.runcall(host_half)
    stats = pstats.Stats(prof).sort_stats("tottime")
    for (fname, line, func), (_, ncalls, tottime, cumtime, _) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:8]:
        print(f"  {tottime:8.3f} s self {cumtime:8.3f} s cum x{ncalls:<7d} "
              f"{Path(fname).name}:{line} {func}")


def phase_content():
    """Synthetic model on an ellipsoid: CUDA == CPU exactly, and the
    instance is the ellipsoid."""
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.synthetic import SyntheticModule

    shape = (12, 32, 32)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    vol = (((zz - 6.0) ** 2 / 16 + (yy - 15.0) ** 2 / 64
            + (xx - 16.0) ** 2 / 49) <= 1.0).astype(np.float32)
    kwargs = dict(labels=[1], thing_list=[1], mode="stack", qlen=3,
                  label_divisor=100, block_size=4, padding_factor=16,
                  max_centers=64, min_size=4, min_span=1, progress=False)
    gpu = run_inference3d(SyntheticModule(), vol, device="cuda", **kwargs)
    cpu = run_inference3d(SyntheticModule(), vol, device="cpu", **kwargs)
    ins_g, ins_c = gpu[1].instances, cpu[1].instances
    if not ins_c:
        fail("content: no instance found")
    if sorted(ins_g) != sorted(ins_c):
        fail(f"content: CUDA labels {sorted(ins_g)} != CPU {sorted(ins_c)}")
    for label, attrs in ins_c.items():
        other = ins_g[label]
        if tuple(attrs["box"]) != tuple(other["box"]) \
                or not np.array_equal(attrs["starts"], other["starts"]) \
                or not np.array_equal(attrs["runs"], other["runs"]):
            fail(f"content: instance {label} differs between CUDA and CPU")
    truth = np.flatnonzero(vol.reshape(-1) > 0.5)
    best = 0.0
    for attrs in ins_g.values():
        vox = np.concatenate([np.arange(s, s + r) for s, r in
                              zip(attrs["starts"], attrs["runs"])])
        inter = len(np.intersect1d(vox, truth))
        best = max(best, inter / (len(vox) + len(truth) - inter))
    print(f"content: {len(ins_g)} instance(s), CUDA == CPU exactly, "
          f"IoU with the ellipsoid {best:.4f}")
    if best < 0.9:
        fail(f"content: best IoU with the ellipsoid {best:.4f} < 0.9")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also break the main path's time down "
                             "(engine alone, forward, postprocess, "
                             "profiler trace)")
    args = parser.parse_args()

    root = Path(__file__).resolve().parent
    if not (root / "empanada_torch" / "csrc").is_dir():
        fail("run from the root of a checkout (empanada_torch/ not found)")
    sys.path.insert(0, str(root))
    try:
        import torch
    except ImportError:
        fail("torch is not installed")

    phase_device()
    from empanada_torch.device import set_parity_numerics

    set_parity_numerics()
    phase_build()
    row = phase_group_kernel()
    launches, model, vol = phase_main_path()
    row["launches"] = launches["group_pixels"]
    if args.profile:
        phase_breakdown(model, vol)
    del model
    phase_content()

    print("kernels: group_pixels")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
