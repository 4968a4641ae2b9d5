#!/usr/bin/env python3
"""Build and drive the PyTorch port (empanada_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases (each prints its results; any
failure exits non-zero before the final line):

1. device: require CUDA; print the card's name and power limit;
2. build every hand-written kernel from ``empanada_torch/csrc`` (one
   nvcc per source, all started together) and the C++ host core from
   ``empanada_torch/core/_native/core.cpp`` (g++), and print the
   compiler, the flags and the library's path;
3. the host core: each of its 14 entry points against the port's numpy
   path on seeded inputs (exact equality of every integer output; an
   input the native path has to decline must leave it uncalled and give
   the same answer), one line per entry point with native and numpy ms;
   then each kernel against its plain PyTorch version on the card (exact
   integer equality) at the stack path's shape, at the fine-boundary
   and dense shapes and at the blocks the orthoplane path's three axes
   give it (derived from its volume), then timings: the kernel's device time (torch.profiler), the
   wrapper's (CUDA events, host included), the plain version's and a
   library call's, beside the bounds;
4. the stack main path at full width: MitoNet (PanopticBiFPNPR on
   regnety_6p4gf) from a seeded init through
   ``run_inference3d(mode="stack")`` on a seeded uint8 volume, with the
   kernel launch counts and the host core's call counts read around
   that run (a main path that ran with the numpy host half fails);
   plus the full-width model forward on CUDA against the CPU on a small
   input;
5. the orthoplane main path at full width: the same model through
   ``run_inference3d(mode="orthoplane")`` on a seeded uint8 volume with
   three different sides, none a multiple of 128: per-axis times and
   kernel launches, the host core's call counts, the consensus time,
   the 3D instances; then the same run with the numpy host half, whose
   trackers must equal the native run's, RLE for RLE;
6. fill and store: the consensus filled into a zarr store, read back
   and held against a dense numpy fill;
7. the command line: the model exported to a descriptor, a crop of the
   volume written as a zarr store, ``cli.infer3d.main`` in orthoplane
   mode, and its class zarr held against a fill of its tracker json
   (needs PyYAML; says so and does not run where that is missing);
8. content: a parameter-free synthetic model on an ellipsoid volume in
   stack and in orthoplane mode, CUDA vs CPU instance RLEs exactly
   equal and matching the ellipsoid;
9. training: a synthetic EM-like training set written as PNG files
   (two subdirectories of 200 and 120 images of 384², an eval set of 8,
   a finetune set of 48); MitoNet's recipe
   (``configs/mitonet_panoptic_bifpn_pointrend.yaml``: batch 64 of 256²
   crops, bf16 autocast, AdamW + OneCycle, PointRend 1024 points) at
   full width for 2 epochs (10 steps) through ``Trainer.fit``, with
   validation through the 2D engine (K1) and a checkpoint after each
   epoch: steps/s, images/s, data-wait share, peak memory, the loss per
   step; a validation alone; a resume for a third epoch; ``python -m
   empanada_torch export``; one f32 train step on the card against the
   CPU, and in bf16; ``python -m empanada_torch finetune`` with
   ``configs/finetune.yaml``'s TRAIN (stage4 frozen below, batch 16),
   the frozen stages bit-identical and their BN statistics moved; the
   finetuned descriptor's stack inference on the card;
10. Panoptic-DeepLab: ``PanopticDeepLabPR`` from
   ``configs/panoptic_deeplab_pointrend.yaml``'s MODEL block (resnet50,
   stage 4 at stride 16, decoder 256, ASPP 2/4/6, an instance decoder at
   0.5, PointRend) at full width from a seeded init: its parameter
   count; PDL, PDL-PR and PDL-BC forwards on the card against the CPU;
   the orthoplane path on ``synthetic_em_volume(ORTHO_SHAPE)`` (slices/s,
   K1 launches per axis, host-core calls); ``evaluate3d`` on a crop
   against its ground truth (every metric); the ground truth scored
   against itself;
11. boundary-contour: ``PanopticDeepLabBC`` from
   ``configs/panoptic_deeplab_bc.yaml`` at full width through
   ``run_bc_inference3d(mode="orthoplane")`` on the same volume
   (per-axis and watershed seconds, 3D instances); the device watershed
   against the numpy one on stacks made from synthetic ground truth
   (labels equal; both times, levels, rounds); the parameter-free BC
   twin on ellipsoids, CUDA labels == CPU labels, scored against the
   ellipsoids; ``evaluate3d_bc`` on the crop (its ``_bc_seg.zarr`` ==
   a fill of its ``pred_bc.json``); one epoch of the BC recipe through
   ``Trainer.fit`` on phase 9's set, validation through ``BCEngine``
   (steps/s, images/s, peak memory, the loss per step);
12. artifacts: MitoNet at full width from its seeded init written as a
   reference-layout TorchScript archive; ``python -m empanada_torch
   export --from-torch --quantize`` on it (the imported state equals the
   source bit for bit; the weight-only int8 artifact); a calibrated int8
   export on the card (2 batches of 8 normalized slices of the
   orthoplane volume: scope, calibrated paths, int8 products a forward,
   the drift record); float32 and int8 orthoplane runs from the
   descriptor on that volume (slices/s of both, per-axis times, K1
   launches); for every distinct int8 conv shape of the encoder at the
   xy block, the card path (im2col + ``torch._int_mm``) == the plain
   path exactly, timed beside cuDNN float32; ``infer3d --quantized`` on
   a crop;
13. curation: ``curate dedup`` on PNG slices of the synthetic volume
   (written patches == source pixels); ``PatchQualityFilter("resnet34")``
   on the card over 1024 patches of 224^2 (images/s; CUDA vs CPU scores
   on 32 patches, tolerance 1e-4); ``curate flipbooks``, ``split-stack``,
   ``merge-batch`` and ``group-dirs`` on the result, checking the trees
   they write;
14. multi-device, at the world of every visible card (1 where one card
   is visible): (a) MitoNet at full width through
   ``run_inference3d(mode="orthoplane", mesh=create_mesh(count))`` on the
   orthoplane volume, its consensus equal to the same run without a
   mesh, RLE for RLE (slices/s of both, K1 launches per axis and by
   card); (b) K1 on every visible card at the main and xy shapes, ids
   equal to the plain version's; (c) ``multihost_run_inference3d`` over
   2 processes on one card (gloo), rank 0's consensus equal to one
   process's ``run_inference3d`` at the same block (seconds of both,
   each rank's blocks and copied bytes); (d) one float32 step of the
   MitoNet recipe at full width (global batch 16 of 256², TF32 off) at
   world 2 on one card (gloo) and at world ``device_count`` (NCCL), each
   held against one process's step to the JAX package's data-parallel
   tolerances, then bf16 images/s, peak memory and the collectives'
   time in a profiled step per rank; (e) ``python -m empanada_torch
   train`` on the recipe (batch 64 of 256², bf16) for one epoch over
   every card: each rank's images/s, data-wait share and peak memory,
   one checkpoint, written by rank 0. Its ranks run as ``python3
   chip_smoke.py --worker <kind> ...``; (c) runs on the resident path
   (each rank's block paths are noted and checked);
15. resident and exported program: (a) MitoNet at full width through
   ``run_inference3d(mode="orthoplane", resident=True)`` beside the
   streaming run in the same call, consensus equal RLE for RLE (slices/s,
   per-axis forward seconds and seconds, K1 launches per axis, the
   one-time upload's bytes and ms; the block path of each axis counted
   by the script); (b) each axis from the host view in chunks of two
   blocks against the device tensor, maps and runs equal slice for
   slice (engine-alone seconds of both); (c) ``infer3d --resident`` on a
   .npy crop, its class zarr byte-identical to the streaming command's;
   (e) ``export --stablehlo`` at (1, 512, 512, 1), the .pt2 moved to the
   card against the eager forward (TF32 off, within 1e-4 of max
   |value|), export seconds and file size; (f) ``block_cost_analysis``
   of the xy block beside its engine-alone time and the share of the
   float32 peak, then the same in bfloat16 against the bfloat16 peak,
   and the grouped 3x3 convolutions' share of an xy block forward in
   each dtype;
16. the bench MitoNet (``empanada_torch.bench_heads``: the seeded
   full-width backbone with the committed ridge-fitted heads, whose
   backbone fingerprint is checked) on the bench volumes: (a) the
   headline orthoplane volume (128, 320, 320) with 150 disjoint
   instances, streaming, after a warm-up of its slice shapes: slices/s,
   per-axis forward and whole seconds, K1 launches, instances matched a
   slice and overflow slices, consensus seconds and instances against
   the ground truth's; the main path's own K1 ids on every block of
   every axis held against ``group_pixels_plain`` on the same centers,
   valid mask and offsets; the host half again with the numpy host half
   on the same device outputs (no device work), consensus equal RLE for
   RLE; ``resident=True``, consensus equal; (b) that consensus scored
   against its ground truth with the port's evaluator (semantic IoU,
   F1@0.5, PQ; fails below 0.5 semantic IoU); K1 timed on the busiest
   recorded xy block; (c) the product-density slab (128, 512, 512) with
   900 instances at 512 centers, with the same numbers, the same K1
   check and the same scoring; (d) the headline volume with content-free
   heads (the device ceiling without content); the same in bfloat16
   (the model built with ``dtype="bfloat16"``, as the MitoNet recipe's
   ``MODEL.dtype``): the headline and the slab with every block's K1
   ids against the plain version and both scored (fails below 0.5
   semantic IoU), the content-free ceiling, each beside float32's
   numbers;
17. the benchmark entry point: ``python -m empanada_torch.bench`` as a
   subprocess, its one JSON line parsed and printed, its keys, dtype,
   modes and IoU gate checked (a failure fails the run);
18. entry, the counterpart of the JAX package's root
   ``__graft_entry__.py``: ``empanada_torch.entry.entry()`` (MitoNet at
   full width, (1, 1, 256, 256)), ``fn(*example_args)`` and ``fn`` on a
   seeded image equal to the module's own forward bit for bit, the
   forward's median ms (CUDA events, float32, TF32 off), ``torch.export``
   of ``fn`` against the eager forward; ``dryrun_multichip(n)`` at n =
   ``device_count`` (NCCL, a card a rank) and at n = 2 (on one card: two
   gloo ranks share it, the mesh repeats it): the tiny recipe's step at
   world n against one process's, each number beside its tolerance, and
   the mesh orthoplane consensus equal to the run without a mesh, with
   K1's launches counted around each dry run and every block's ids held
   against ``group_pixels_plain``. ``--multi-device-only`` runs it after
   phase 14.

Each phase prints its seconds. The line before the last is the kernel table (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

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

# grouping kernel shapes: B, grid H, W, K, step, valid centers per slice.
# orthoplane_group_shapes() adds the blocks of the orthoplane path's axes
_MIX = [256, 256, 40, 0, 256, 17, 200, 63]
GROUP_SHAPES = {
    "main": (8, 128, 128, 256, 4.0, _MIX),
    "fine": (8, 512, 512, 256, 1.0,
             [136, 120, 150, 136, 128, 144, 136, 140]),
    "dense": (8, 128, 128, 512, 4.0,
              [400, 380, 420, 400, 512, 390, 410, 388]),
    # the training path's validation: one 384^2 eval image (a multiple
    # of the padding factor 128) grouped at full resolution
    "val": (1, 384, 384, 256, 1.0, [120]),
}
AXES = ("xy", "xz", "yz")

# the orthoplane main path's volume: three different sides, none a
# multiple of the padding factor (128)
ORTHO_SHAPE = (96, 192, 320)
NORMS = {"mean": 0.57, "std": 0.12}
MITONET = {"arch": "PanopticBiFPNPR", "encoder": "regnety_6p4gf",
           "num_classes": 1}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def axis_block(shape, axis, padding_factor=128):
    """(block size, padded slice shape) that the engine derives for the
    slices of ``axis`` of a volume of ``shape``: slices padded to the
    padding factor, the automatic block size for that slice shape
    (median kernel 3)."""
    from empanada_torch.inference.fused import FusedStackEngine

    engine = SimpleNamespace(block_size=None, mid=1, mesh=None)
    padded = tuple(-(-side // padding_factor) * padding_factor
                   for i, side in enumerate(shape) if i != axis)
    return FusedStackEngine._resolve_block(engine, padded,
                                           shape[axis]), padded


def orthoplane_group_shapes():
    """The grouping kernel's shape on each axis of the orthoplane main
    path, as the engine derives it from ORTHO_SHAPE (``axis_block``), the
    center grid at a quarter of the slice."""
    shapes = {}
    for axis, name in enumerate(AXES):
        b, (ph, pw) = axis_block(ORTHO_SHAPE, axis)
        shapes[name] = (b, ph // 4, pw // 4, 256, 4.0, (_MIX * 8)[:b])
    return shapes


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


def device_ms(fn, reps, kernel=None, whole=True):
    """Mean device milliseconds a call of fn() over reps back-to-back
    calls: the self device time that torch.profiler records for the
    kernels whose name contains ``kernel`` (every device event when None),
    divided by reps. The profiler can lose device records: a trace
    that does not hold all reps launches of ``kernel`` is taken again,
    up to 3 times. Fails when no trace is whole (with ``whole=False``:
    the last trace's mean over the launches it holds, said so), or when
    the profiler records no device time."""
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
        if whole or count <= 0:
            fail(f"profiler counted {count} launches of {kernel}, not "
                 f"{reps}, in 3 traces")
        print(f"device time of {kernel}: the mean over the {count} "
              f"launches of {reps} that the last trace holds")
        reps = count
    if total <= 0:
        fail(f"torch.profiler recorded no device time for "
             f"{kernel or 'the call'}")
    return total / 1e3 / reps


def card_name_and_limit():
    """Card 0's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    print(card_name_and_limit())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible device(s)")


def phase_build():
    """Build the CUDA kernels and the C++ host core (and load it); either
    failure raises and ends the run."""
    from empanada_torch import cuda_build, native_build
    from empanada_torch.core import native

    t0 = time.time()
    libs = cuda_build.build_all()
    print(f"built {len(libs)} kernel(s) in {time.time() - t0:.1f} s: "
          f"{', '.join(sorted(libs))}")
    t0 = time.time()
    path = native_build.build()
    if native.get_lib() is None:
        fail("the numpy host half is asked for (EMPANADA_TORCH_NO_NATIVE): "
             "the main paths must run with the C++ host core")
    print(f"built the host core in {time.time() - t0:.1f} s: "
          f"{native_build.compiler()} {' '.join(native_build.CXX_FLAGS)} "
          f"{native_build.SOURCE} -> {path}; "
          f"{len(native.ENTRY_POINTS)} entry points bound")


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

    b, h, w, k, step, default_valid = GROUP_SHAPES[shape]
    n_valid = default_valid if n_valid is None else n_valid
    centers = rng.integers(0, h if h == w else (h, w),
                           (b, k, 2)).astype(np.int32)
    valid = np.zeros((b, k), bool)
    for i, nv in enumerate(n_valid):
        valid[i, rng.permutation(k)[:nv] if i % 2 == 0 else slice(0, nv)] \
            = True
    noise = rng.standard_normal((b, h, w, 2)).astype(np.float32)
    c = torch.from_numpy(centers).cuda()
    v = torch.from_numpy(valid).cuda()
    if kind == "em":
        near = group.group_pixels_plain(c, v, torch.zeros((b, h, w, 2),
                                                          device="cuda"),
                                        step).long()
        target = torch.gather(
            c.float() * step, 1,
            (near - 1).clamp(min=0).reshape(b, h * w, 1).expand(-1, -1, 2))
        ys = torch.arange(h, dtype=torch.float32, device="cuda") * step
        xs = torch.arange(w, dtype=torch.float32, device="cuda") * step
        loc = torch.stack(torch.broadcast_tensors(ys[:, None], xs[None]),
                          dim=-1)
        o = torch.from_numpy(noise * 1.5).cuda()
        o = torch.where(near[..., None] > 0,
                        target.reshape(b, h, w, 2) - loc + o, o)
    else:
        o = torch.from_numpy(noise * 12).cuda()
    o[1::2] = torch.round(o[1::2] * 2) / 2
    if kind == "special":
        flat = o.view(b, h * w, 2)
        values = [float("nan"), float("inf"), -float("inf"), 1e6, -1e6]
        for i in range(b):
            at = torch.from_numpy(rng.choice(h * w, 5, replace=False)).cuda()
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


def group_timing(c, v, o, step, whole=True):
    """One input set's numbers: device ms of the kernel (torch.profiler,
    200 launches; ``whole`` as in device_ms), the wrapper's CUDA-event
    ms, the plain version's and the library yardstick's device ms, the
    bounds, and the tile counters with the time their kept pairs would
    take at the peak rate."""
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
    row = {"ms": device_ms(kernel, reps, name, whole)}
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


def best_ms(fn, reps):
    """(fn()'s result, the least host milliseconds of reps calls)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def same_nested(a, b):
    """Exact equality of nested dicts / tuples / lists of arrays and
    numbers."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            same_nested(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            same_nested(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def phase_host_core(trackers):
    """Each entry point of the C++ host core against the port's numpy
    path, through the function of the host half that calls it, on seeded
    inputs at the sizes the dense paths give it: the ~1350-instance views
    of ``density_trackers`` (boxes, RLEs, ranges), a 256x384 label image
    (the xy axis's padded slice) and a (16, 64, 96) label volume. Every
    output must be exactly equal (pairs of boxes compared sorted: the
    two paths emit them in different orders). A "declines" case gives
    the native path an input it must not take (non-canonical lists,
    float boxes, a dtype the fill does not cover): the entry point has
    to stay uncalled and the answer has to be the same. Prints one line
    per case: native ms (least of 3) beside numpy ms (one call)."""
    from empanada_torch.core import boxes, ccl, ccl3d, fill, native, ranges, rle
    from empanada_torch.inference import matcher

    rng = np.random.default_rng(7)
    shape = tuple(trackers[0].shape3d)
    views = [list(t.instances.values()) for t in trackers]
    a, b = views[0], views[1]
    boxes_a = np.asarray([i["box"] for i in a], np.int64)
    boxes_b = np.asarray([i["box"] for i in b], np.int64)
    rows, cols, _, _ = boxes.box_iou_pairs(boxes_a, boxes_b)
    sr_a = [i["starts"] for i in a], [i["runs"] for i in a]
    sr_b = [i["starts"] for i in b], [i["runs"] for i in b]

    def as_ranges(inst):
        return np.stack([inst["starts"], inst["starts"] + inst["runs"]],
                        axis=1)

    def reverse(inst):
        return dict(inst, starts=inst["starts"][::-1].copy(),
                    runs=inst["runs"][::-1].copy())

    def strip(out):
        if isinstance(out, list):
            return [strip(o) for o in out]
        return {k: v for k, v in out.items() if k != "_canon"}

    def sorted_pairs(out):
        order = np.lexsort((out[1], out[0]))
        return tuple(o[order] for o in out)

    lists = [as_ranges(i) for i in a[:400]]
    covered = ranges.concat_sort_ranges(lists + [as_ranges(i)
                                                 for i in b[:400]])
    everything = [ranges.join_ranges([as_ranges(i) for i in v])
                  for v in views[:2]]
    votes = [as_ranges(i) for v in views for i in v[:60]]
    group = a[:8] + b[:8]
    groups = [[views[0][k], views[1][k], views[2][k]]
              for k in range(min(300, *map(len, views)))]
    image = (rng.integers(1, 3, (256, 384))
             * (rng.random((256, 384)) < 0.55)).astype(np.int32)
    s, e, v = ccl.image_to_runs(image)
    image_runs = s[v != 0], e[v != 0], v[v != 0]
    volume = (rng.integers(1, 3, (16, 64, 96))
              * (rng.random((16, 64, 96)) < 0.35)).astype(np.int32)
    instances = trackers[0].instances
    wide = _wide_boxes(rng, 300)

    # (entry points, what, function, canonical form, declines)
    keep = (lambda out: out)
    cases = [
        (["coverage_ranges"], f"coverage of {len(covered)} ranges, thr 2",
         lambda: ranges._coverage_ranges(covered, 2), keep, False),
        (["ranges_intersection"],
         f"{len(everything[0])} x {len(everything[1])} ranges",
         lambda: ranges.ranges_intersection(*everything), keep, False),
        (["pair_intersections"],
         f"{len(rows)} box-screened pairs of {len(a)} x {len(b)} instances",
         lambda: rle.rle_pairwise_intersections(*sr_a, *sr_b, rows, cols),
         keep, False),
        (["kway_merge_ranges"], f"{len(lists)} start-sorted lists",
         lambda: ranges.concat_sort_ranges(lists), keep, False),
        (["kway_merge_ranges"], "declines: one list unsorted",
         lambda: ranges.concat_sort_ranges([lists[0][::-1]] + lists[1:]),
         keep, True),
        (["kway_vote"], f"vote 2 of {len(votes)} canonical lists",
         lambda: ranges.vote_by_ranges(votes, 2), keep, False),
        (["kway_vote"], "declines: one list unsorted",
         lambda: ranges.vote_by_ranges([votes[0][::-1]] + votes[1:], 2),
         keep, True),
        (["kway_union_sr"], f"union of {len(group)} instances",
         lambda: matcher.merge_attrs_many(group), strip, False),
        (["kway_union_sr"], "declines: one instance unsorted",
         lambda: matcher.merge_attrs_many([reverse(group[0])] + group[1:]),
         strip, True),
        (["kway_union_batch"], f"{len(groups)} groups of 3 instances",
         lambda: matcher.merge_attrs_batch(groups), strip, False),
        (["kway_union_batch"], "declines: one instance unsorted",
         lambda: matcher.merge_attrs_batch(
             [[reverse(groups[0][0])] + groups[0][1:]] + groups[1:]),
         strip, True),
        (["rle_union"], "two canonical instances",
         lambda: rle.merge_rles(a[0]["starts"], a[0]["runs"],
                                b[0]["starts"], b[0]["runs"]), keep, False),
        (["rle_union"], "declines: first instance unsorted",
         lambda: rle.merge_rles(a[0]["starts"][::-1], a[0]["runs"][::-1],
                                b[0]["starts"], b[0]["runs"]), keep, True),
        (["box_overlap_pairs"],
         f"{len(a)} x {len(b)} 3D boxes = {len(a) * len(b)} candidate pairs",
         lambda: boxes.box_iou_pairs(boxes_a, boxes_b), sorted_pairs, False),
        (["box_overlap_pairs"], f"{len(a)} 3D boxes against themselves",
         lambda: boxes.box_iou_pairs(boxes_a), sorted_pairs, False),
        (["box_overlap_pairs"],
         f"{len(wide)} boxes that all overlap (the buffer grows)",
         lambda: boxes.box_iou_pairs(wide), sorted_pairs, False),
        (["box_overlap_pairs"], "declines: float boxes",
         lambda: boxes.box_iou_pairs(boxes_a - 0.25, boxes_b + 0.0),
         sorted_pairs, True),
        (["encode_runs_i32"], "256x384 label image",
         lambda: ccl.image_to_runs(image), keep, False),
        (["runs_ccl"], f"{len(image_runs[0])} runs, connectivity 8",
         lambda: ccl.runs_connected_components(*image_runs, 384, 8), keep,
         False),
        (["runs_ccl"], f"{len(image_runs[0])} runs, connectivity 4",
         lambda: ccl.runs_connected_components(*image_runs, 384, 4), keep,
         False),
        (["runs_ccl3d"], "(16, 64, 96) label volume, connectivity 26",
         lambda: ccl3d.connected_components_3d(volume, 26), keep, False),
        (["runs_ccl3d"], "(16, 64, 96) label volume, connectivity 6",
         lambda: ccl3d.connected_components_3d(volume, 6), keep, False),
        (["fill_runs_i32"], f"{len(instances)} instances into int32 {shape}",
         lambda: fill.numpy_fill_instances(np.zeros(shape, np.int32),
                                           instances), keep, False),
        (["fill_runs_i64"], f"{len(instances)} instances into int64 {shape}",
         lambda: fill.numpy_fill_instances(np.zeros(shape, np.int64),
                                           instances), keep, False),
        (["fill_runs_i32"], "chunked, uint32 chunks through an int32 view",
         lambda: fill.chunked_fill_instances(
             np.zeros(shape, np.uint32), instances, chunks=(32, 64, 64)),
         keep, False),
        (["fill_runs_i64"], "chunked, uint64 chunks through an int64 view",
         lambda: fill.chunked_fill_instances(
             np.zeros(shape, np.uint64), instances, chunks=(32, 64, 64)),
         keep, False),
        (["fill_runs_i32", "fill_runs_i64"], "declines: uint16 chunks",
         lambda: fill.chunked_fill_instances(
             np.zeros(shape, np.uint16), instances, chunks=(32, 64, 64)),
         keep, True),
    ]
    held = set()
    for entry_points, what, fn, canon, declines in cases:
        native.reset_calls()
        got, ms = best_ms(fn, 3)
        calls = dict(native.CALLS)
        for name in entry_points:
            if (calls[name] == 0) != declines:
                fail(f"host core {name} ({what}): {calls[name]} native "
                     f"calls, expected {'none' if declines else 'some'}")
        native.reset_calls()
        with native.numpy_host_half():
            want, plain_ms = best_ms(fn, 1)
        if any(native.CALLS.values()):
            fail(f"host core {entry_points[0]} ({what}): the numpy path "
                 f"called the library: {native.CALLS}")
        if not same_nested(canon(got), canon(want)):
            fail(f"host core {entry_points[0]} ({what}): native != numpy")
        if not declines:
            held.update(entry_points)
        print(f"host core {' / '.join(entry_points)} ({what}): native "
              f"{ms:.3f} ms, numpy {plain_ms:.3f} ms; equal")
    missing = set(native.ENTRY_POINTS) - held
    if missing:
        fail(f"host core: no case held {sorted(missing)} against numpy")
    print(f"host core: {len(held)} entry points == numpy exactly over "
          f"{len(cases)} cases")


def _wide_boxes(rng, n):
    """n 2D boxes that all overlap one another: n^2 pairs, more than the
    first output buffer of box_overlap_pairs holds."""
    lo = rng.integers(0, 100, (n, 2))
    return np.concatenate([lo, lo + 10 ** 6], axis=1).astype(np.int64)


def phase_group_kernel():
    """group_pixels kernel vs its plain version, exact, at the main,
    fine, dense and the orthoplane path's xy / xz / yz shapes over
    random-subset and prefix masks, random, EM-like and special offsets
    (NaN, +-inf, +-1e6) and, at main, the full / sparse / empty mixes at
    steps 1 and 4; then the timings. Returns the kernel's JSON row
    (launches filled in later)."""
    from empanada_torch import cuda_build

    print_ptxas("group_pixels", cuda_build.build_log("group_pixels"))
    GROUP_SHAPES.update(orthoplane_group_shapes())
    rng = np.random.default_rng(0)
    b = GROUP_SHAPES["main"][0]
    cases = [("main", kind, None, step) for kind in ("random", "em",
                                                     "special")
             for step in (1.0, 4.0)]
    cases += [("main", "random", n_valid, step)
              for n_valid in ([256] * b, [40] * b, [0] * b)
              for step in (1.0, 4.0)]
    cases += [(shape, kind, None, GROUP_SHAPES[shape][4])
              for shape in ("fine", "dense", "val") + AXES
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
    blocks = ", ".join("{} {}x{}x{}".format(a, *GROUP_SHAPES[a][:3])
                       for a in AXES)
    print(f"group_pixels: kernel == plain exactly over {len(cases)} cases "
          f"(shapes main, fine, dense, val and the orthoplane blocks "
          f"{blocks}; "
          f"offsets "
          f"random, EM-like, special; random and prefix masks; steps 1, 4 "
          f"at main)")

    shapes = {}
    for shape, (b, h, w, k, step, n_valid) in GROUP_SHAPES.items():
        for kind in ("random", "em"):
            c, v, o = group_inputs(np.random.default_rng(1), shape, kind)
            row = group_timing(c, v, o, step)
            shapes.setdefault(shape, {})[kind] = row
            print(f"group_pixels {shape} (B={b}, {h}x{w}, K={k}, "
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


def inference_kwargs(mode):
    """The settings both main paths call run_inference3d with."""
    return dict(labels=[1], thing_list=[1], mode=mode, qlen=3,
                label_divisor=20000, norms=NORMS, device="cuda",
                min_size=500, min_span=4)


def host_path_ran(path, required):
    """Print which host half a main path ran with and the host core's
    call counts by entry point (set to 0 just before that run); fail if
    it ran with the numpy host half, or without calling one of the
    ``required`` entry points."""
    from empanada_torch.core import native

    calls = {k: v for k, v in native.CALLS.items() if v}
    if native.get_lib() is None or not calls:
        fail(f"the {path} main path ran with the numpy host half")
    print(f"{path} host half: native (C++ host core), calls by entry "
          f"point {calls}")
    for name in required:
        if name not in calls:
            fail(f"the {path} main path never called the host core's "
                 f"{name}")


# entry points that the host half of every inference run must reach:
# run labeling, the matcher's batched intersections
HOST_REQUIRED = ("runs_ccl", "pair_intersections")


def phase_main_path():
    """Full-width MitoNet through run_inference3d(stack) on the card;
    returns the kernel launch counts of that run, the model and the
    volume."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.core import native
    from empanada_torch.models import create_model
    from empanada_torch.ops import group

    cfg = dict(MITONET)
    model = create_model(cfg.pop("arch"), device="cuda", seed=0, **cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"MitoNet (PanopticBiFPNPR, regnety_6p4gf): {n_params} parameters")

    # the full-width forward, CUDA vs CPU on a small input
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 128, 128))
                         .astype(np.float32))
    with torch.inference_mode():
        got = {k: v.float().cpu() for k, v in
               model(x.cuda(), interpolate_ins=False).items()}
        cpu_model = create_model(MITONET["arch"], device="cpu", **cfg)
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

    kwargs = dict(inference_kwargs("stack"), progress=False)
    rng = np.random.default_rng(2)
    # warm-up on a short stack of the same slice shape (same block size)
    run_inference3d(model, em_like_volume(rng, 4, 512, 512, 10), **kwargs)
    vol = em_like_volume(rng, 16, 512, 512)

    torch.cuda.synchronize()
    group.reset_launches()
    native.reset_calls()
    stats = {}
    t0 = time.time()
    result = run_inference3d(model, vol, stats=stats, **kwargs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(group.LAUNCHES)
    host_path_ran("stack", HOST_REQUIRED)

    if sorted(result) != [1] or result[1].shape3d != vol.shape:
        fail(f"main path returned {sorted(result)}")
    n_inst = len(result[1].instances)
    axis = stats["axes"]["xy"]
    print(f"stack main path: {vol.shape[0]} slices of {vol.shape[1]}x"
          f"{vol.shape[2]} in {seconds:.3f} s = "
          f"{vol.shape[0] / seconds:.2f} slices/s; "
          f"{axis['instances_matched']} matched 2D instances, {n_inst} 3D "
          f"instances, {axis['overflow_slices']} overflow slices; kernel "
          f"launches {launches}")
    if launches["group_pixels"] <= 0:
        fail("the stack main path never launched the group_pixels kernel")
    return launches, model, vol


class AxisProbe:
    """The orthoplane volume as run_inference3d reads it, with a note of
    each axis's first slice read (the time, and the kernel launch counts
    at that moment: the axes stream one after the other, so the counts at
    an axis's first read are the sums over the axes before it) and of the
    seconds spent reading each axis's slices."""

    def __init__(self, vol, counts):
        self.vol = vol
        self.shape, self.dtype = vol.shape, vol.dtype
        self.counts = counts
        self.first = {}
        self.read_seconds = {}

    def __getitem__(self, key):
        axis = next(a for a, k in enumerate(key) if not isinstance(k, slice))
        if axis not in self.first:
            self.first[axis] = (time.time(), dict(self.counts))
        t0 = time.time()
        out = np.ascontiguousarray(self.vol[key])
        self.read_seconds[axis] = self.read_seconds.get(axis, 0.0) \
            + time.time() - t0
        return out


def warm_axes(model, vol, kwargs, label):
    """One block of each axis's slices (same slice shape and block size
    as the axis gives the engine: its padded slice, the automatic block
    size) through run_inference3d in stack mode."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d

    t0 = time.time()
    warm = [axis_block(vol.shape, axis, kwargs.get("padding_factor", 128))[0]
            for axis in range(3)]
    for axis, n_warm in enumerate(warm):
        head = np.ascontiguousarray(np.moveaxis(vol, axis, 0)[:n_warm])
        run_inference3d(model, head, **dict(kwargs, mode="stack",
                                            progress=False))
    torch.cuda.synchronize()
    print(f"{label} warm-up ({' / '.join(map(str, warm))} slices of the "
          f"three slice shapes, stack mode): {time.time() - t0:.3f} s")


def timed_orthoplane(model, vol, kwargs, label):
    """run_inference3d(orthoplane) on the card with the kernel and
    host-core counts set to 0 just before and read just after; prints
    slices/s and per axis its start, forward seconds, host tail, matched
    instances, kernel launches and slice reads; fails where an axis
    launched no grouping kernel or the host half ran numpy. Returns
    (result, stats, seconds, {"total", "per_axis"})."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.core import native
    from empanada_torch.ops import group

    group.reset_launches()
    native.reset_calls()
    probe = AxisProbe(vol, group.LAUNCHES)
    stats = {}
    t0 = time.time()
    result = run_inference3d(model, probe, stats=stats, progress=True,
                             **kwargs)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(group.LAUNCHES)
    host_path_ran(label, HOST_REQUIRED + ("kway_vote",))

    if sorted(result) != [1] or tuple(result[1].shape3d) != vol.shape:
        fail(f"{label} path returned {sorted(result)} with shape3d "
             f"{result[1].shape3d if 1 in result else None}, not "
             f"{vol.shape}")
    n_slices = sum(vol.shape)
    print(f"{label} main path: volume {vol.shape} uint8, {n_slices} "
          f"slices over three axes in {seconds:.3f} s = "
          f"{n_slices / seconds:.2f} slices/s "
          f"({vol.size / 512 ** 2 * 3 / seconds:.2f} 512^2-slice "
          f"equivalents/s)")
    firsts = [probe.first[a][1]["group_pixels"] for a in range(3)] \
        + [launches["group_pixels"]]
    per_axis = {}
    for a, name in enumerate(AXES):
        ax = stats["axes"][name]
        per_axis[name] = firsts[a + 1] - firsts[a]
        print(f"{label} {name}: {ax['slices']} slices, started at "
              f"{probe.first[a][0] - t0:.3f} s, forward "
              f"{ax['forward_seconds']:.3f} s, with its host tail "
              f"{ax['seconds']:.3f} s; {ax['instances_matched']} matched 2D "
              f"instances, {ax['overflow_slices']} overflow slices; "
              f"group_pixels launches {per_axis[name]}; slice reads "
              f"{probe.read_seconds[a]:.3f} s")
        if per_axis[name] <= 0:
            fail(f"the {label} path launched no group_pixels kernel on "
                 f"axis {name}")
    print(f"{label} consensus: {stats['consensus_seconds']:.3f} s, "
          f"{len(result[1].instances)} 3D instances; kernel launches "
          f"{launches}")
    return result, stats, seconds, {"total": launches["group_pixels"],
                                    "per_axis": per_axis}


def phase_orthoplane(model):
    """Full-width MitoNet through run_inference3d(orthoplane) on the
    card, after a warm-up of each axis's slice shape; returns the kernel
    launch counts of that run (total and per axis), the consensus and
    the volume."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.core import native

    d, h, w = ORTHO_SHAPE
    vol = em_like_volume(np.random.default_rng(4), d, h, w, n_blobs=30)
    kwargs = inference_kwargs("orthoplane")
    warm_axes(model, vol, kwargs, "orthoplane")
    result, stats, seconds, ortho_launches = timed_orthoplane(
        model, vol, kwargs, "orthoplane")
    n_slices = sum(vol.shape)

    # the same run with the numpy host half (after the counts were read:
    # its launches and calls belong to no main path)
    plain_stats = {}
    native.reset_calls()
    t0 = time.time()
    with native.numpy_host_half():
        plain = run_inference3d(model, vol, stats=plain_stats,
                                progress=False, **kwargs)
    torch.cuda.synchronize()
    plain_seconds = time.time() - t0
    if any(native.CALLS.values()):
        fail(f"the numpy host half called the host core: {native.CALLS}")
    tails = " / ".join(
        f"{plain_stats['axes'][name]['forward_seconds']:.3f} "
        f"{plain_stats['axes'][name]['seconds']:.3f}" for name in AXES)
    print(f"orthoplane with the numpy host half: {plain_seconds:.3f} s = "
          f"{n_slices / plain_seconds:.2f} slices/s (native: "
          f"{seconds:.3f} s); forward and tail seconds xy / xz / yz "
          f"{tails}; consensus {plain_stats['consensus_seconds']:.3f} s")
    counts = [(stats["axes"][name]["instances_matched"],
               plain_stats["axes"][name]["instances_matched"])
              for name in AXES]
    if any(n != m for n, m in counts) or not same_instances(
            result[1].instances, plain[1].instances):
        fail(f"orthoplane: the consensus with the native host half "
             f"differs from the one with the numpy host half (matched 2D "
             f"instances per axis {counts})")
    print(f"orthoplane: consensus with the native host half == with the "
          f"numpy host half, RLE for RLE ({len(plain[1].instances)} "
          f"instances; matched 2D instances per axis {counts})")
    return ortho_launches, result, vol


def label_volume_instances(vol):
    """{label: {"box", "starts", "runs"}} of a 3D label volume, in the
    trackers' form: flat runs in raveled coordinates, a 3D box each."""
    d, h, w = vol.shape
    flat = vol.reshape(-1)
    cuts = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [flat.size]])
    labels = flat[starts]
    order = np.argsort(labels, kind="stable")
    order = order[labels[order] > 0]
    starts, ends, labels = starts[order], ends[order], labels[order]
    bounds = np.flatnonzero(np.concatenate(
        [[True], labels[1:] != labels[:-1], [True]]))
    z, y = starts // (h * w), (starts // w) % h
    x0, x1 = starts % w, (ends - 1) % w + 1
    instances = {}
    for i0, i1 in zip(bounds[:-1], bounds[1:]):
        sl = slice(i0, i1)
        instances[int(labels[i0])] = {
            "box": (int(z[sl].min()), int(y[sl].min()), int(x0[sl].min()),
                    int(z[sl].max()) + 1, int(y[sl].max()) + 1,
                    int(x1[sl].max())),
            "starts": starts[sl], "runs": ends[sl] - starts[sl]}
    return instances


def density_trackers(n_objects=1500, shape=ORTHO_SHAPE):
    """Three finished trackers at a product-like instance count: three
    views of ``n_objects`` seeded ellipsoids in a volume of ``shape``,
    each view with its own jitter, a tenth of the objects dropped and its
    own numbering, as three axis passes of a trained model give."""
    from empanada_torch.inference.tracker import InstanceTracker

    rng = np.random.default_rng(6)
    centers = rng.uniform(0, shape, (n_objects, 3))
    radii = rng.uniform(3.0, 8.0, (n_objects, 3))
    trackers = []
    for _ in range(3):
        vol = np.zeros(shape, np.uint32)
        keep = rng.random(n_objects) > 0.1
        ids = rng.permutation(n_objects) + 1
        for k in np.flatnonzero(keep):
            c = centers[k] + rng.uniform(-1, 1, 3)
            r = radii[k] * rng.uniform(0.9, 1.1, 3)
            lo = np.maximum(np.floor(c - r).astype(int), 0)
            hi = np.minimum(np.ceil(c + r).astype(int) + 1, shape)
            zz, yy, xx = np.ogrid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            inside = ((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2 \
                + ((xx - c[2]) / r[2]) ** 2 <= 1
            vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]][inside] = ids[k]
        tracker = InstanceTracker(1, 20000, shape, "xy")
        tracker.instances = label_volume_instances(vol)
        tracker.finished = True
        trackers.append(tracker)
    return trackers


def phase_consensus_at_density(trackers, n_objects=1500):
    """The host's consensus and fill on their own at a product-like
    instance count (``--profile``), with the C++ host core and then with
    the numpy host half: the two must agree RLE for RLE. A seeded init's
    own consensus is one instance, so the main path's consensus time
    says nothing of this."""
    from empanada_torch.core import native
    from empanada_torch.inference import patterns

    shape = tuple(trackers[0].shape3d)

    def run():
        t0 = time.time()
        consensus = patterns.create_instance_consensus(trackers, 2, 0.75)
        cons_s = time.time() - t0
        dense = np.zeros(shape, np.uint32)
        t0 = time.time()
        patterns.fill_volume(dense, consensus.instances)
        return consensus, cons_s, time.time() - t0, dense

    native.reset_calls()
    consensus, cons_s, fill_s, dense = run()
    calls = {k: v for k, v in native.CALLS.items() if v}
    with native.numpy_host_half():
        plain, plain_cons_s, plain_fill_s, plain_dense = run()
    print(f"breakdown consensus at density: three views of "
          f"{' / '.join(str(len(t.instances)) for t in trackers)} "
          f"instances in {shape}: consensus native {cons_s:.3f} s, numpy "
          f"{plain_cons_s:.3f} s (host, one thread) -> "
          f"{len(consensus.instances)} instances, "
          f"{int((dense > 0).sum())} voxels; dense uint32 fill native "
          f"{fill_s:.3f} s, numpy {plain_fill_s:.3f} s; native calls "
          f"{calls}")
    if not n_objects // 2 < len(consensus.instances) <= n_objects:
        fail(f"consensus at density: {len(consensus.instances)} instances "
             f"from {n_objects} objects")
    if not same_instances(consensus.instances, plain.instances) \
            or not np.array_equal(dense, plain_dense):
        fail("consensus at density: the native host half's consensus "
             "differs from the numpy host half's")


def dense_fill(shape, instances):
    from empanada_torch.core.fill import numpy_fill_instances

    dense = np.zeros(shape, np.uint32)
    numpy_fill_instances(dense, instances)
    return dense


def phase_fill_store(result, shape, tmp):
    """The consensus through patterns.fill_volume into a zarr store, read
    back, against numpy_fill_instances on a dense array."""
    from empanada_torch.data.zarr_store import create_zarr, open_zarr
    from empanada_torch.inference import patterns

    instances = result[1].instances
    path = str(Path(tmp) / "consensus.zarr")
    store = create_zarr(path, shape, dtype=np.uint32)
    t0 = time.time()
    patterns.fill_volume(store, instances, processes=4)
    seconds = time.time() - t0
    back = np.asarray(open_zarr(path))
    dense = dense_fill(shape, instances)
    if back.shape != dense.shape or not np.array_equal(back, dense):
        fail("fill and store: the zarr store read back differs from the "
             "dense numpy fill")
    print(f"fill and store: {len(instances)} instances, "
          f"{int((dense > 0).sum())} voxels into a zarr store {shape} "
          f"(chunks {store.chunks}, zlib) in {seconds:.3f} s; read back == "
          f"dense numpy fill")


def phase_command_line(model, vol, tmp):
    """export_model -> descriptor; a crop of the volume as a zarr store;
    cli.infer3d.main in orthoplane mode; the class zarr against a fill of
    the tracker json. Returns the kernel launches of that run, or None
    where PyYAML (the descriptor's format) is not installed."""
    try:
        import yaml  # noqa: F401
    except ImportError:
        print("command line: DID NOT RUN: PyYAML is not installed on this "
              "machine, and the descriptor is a yaml file")
        return None
    from empanada_torch.cli import infer3d
    from empanada_torch.core import native
    from empanada_torch.data.zarr_store import create_zarr, open_zarr
    from empanada_torch.export import export_model
    from empanada_torch.inference.tracker import InstanceTracker
    from empanada_torch.ops import group

    tmp = Path(tmp)
    export_model(model.state_dict(), MITONET, str(tmp), "mitonet",
                 norms=NORMS)
    crop = vol[:40, :100, :150]
    store = create_zarr(str(tmp / "crop.zarr"), crop.shape, dtype=np.uint8)
    store[:, :, :] = crop

    group.reset_launches()
    native.reset_calls()
    t0 = time.time()
    infer3d.main([str(tmp / "mitonet.yaml"), str(tmp / "crop.zarr"),
                  "-mode", "orthoplane", "-qlen", "3"])
    seconds = time.time() - t0
    launches = group.LAUNCHES["group_pixels"]
    if launches <= 0:
        fail("the command line never launched the group_pixels kernel")
    host_path_ran("command line", HOST_REQUIRED + ("fill_runs_i32",))

    seg_path = tmp / "crop_orthoplane_seg_class1.zarr"
    json_path = tmp / "crop_orthoplane_class1.json"
    if not (seg_path / ".zarray").exists() or not json_path.exists():
        fail(f"command line: {seg_path.name} or {json_path.name} was not "
             f"written")
    tracker = InstanceTracker()
    tracker.load_from_json(str(json_path))
    seg = np.asarray(open_zarr(str(seg_path)))
    if tuple(tracker.shape3d) != crop.shape or seg.dtype != np.uint32 \
            or not np.array_equal(seg, dense_fill(crop.shape,
                                                  tracker.instances)):
        fail("command line: the class zarr differs from a fill of the "
             "tracker json")
    print(f"command line: infer3d.main on a {crop.shape} zarr crop in "
          f"{seconds:.3f} s (model load included); "
          f"{len(tracker.instances)} instances; class zarr == fill of the "
          f"json; group_pixels launches {launches}")
    return launches


def make_engine(model):
    """The engine as run_inference3d builds it for both main paths."""
    from empanada_torch.inference.fused import FusedStackEngine

    return FusedStackEngine(
        model, None, [1], label_divisor=20000, median_kernel_size=3,
        nms_threshold=0.1, nms_kernel=3, confidence_thr=0.3, stuff_area=0,
        device_norms=NORMS, pipeline_depth=8, device="cuda")


def host_half(blocks, shape3d, axis_name="xy"):
    """One axis's host half on its own (serial, one thread): run decode
    + CCL, forward matching, backward matching, tracking and filters
    over an engine pass's packed blocks (z_indices, padded slice shape,
    packed array)."""
    from empanada_torch.inference import patterns
    from empanada_torch.inference.rle import runs_to_rle_seg, unpack_packed_runs

    matchers = patterns.create_matchers([1], 20000, 0.25, 0.25)
    stack = []
    for z_indices, pad_shape, arr in blocks:
        for j, z in enumerate(z_indices):
            if z is None:
                continue
            s, e, v, shape = unpack_packed_runs(arr[j], pad_shape)
            seg = runs_to_rle_seg(s, e, v, shape, [1], 20000, [1])
            stack.append(patterns.apply_matchers(seg, matchers))
    trackers = patterns.create_axis_trackers({axis_name: 0}, [1], 20000,
                                             shape3d)
    patterns.finish_axis(stack, matchers, trackers[axis_name], len(stack),
                         500, 4)


def host_half_breakdown(label, blocks, shape3d, axis_name, n_slices):
    """One axis's host half alone (serial, one thread) with the C++ host
    core and with the numpy host half, then the native one under
    cProfile: what is left in python."""
    import cProfile
    import pstats

    from empanada_torch.core import native

    native.reset_calls()
    t0 = time.time()
    host_half(blocks, shape3d, axis_name)
    host_s = time.time() - t0
    calls = {k: v for k, v in native.CALLS.items() if v}
    t0 = time.time()
    with native.numpy_host_half():
        host_half(blocks, shape3d, axis_name)
    plain_s = time.time() - t0
    n_runs = sum(int(arr[j, 0, 0]) for z, _, arr in blocks
                 for j, zz in enumerate(z) if zz is not None)
    print(f"{label}: host half alone native {host_s:.3f} s, numpy "
          f"{plain_s:.3f} s for {n_slices} slices ({n_runs} foreground "
          f"runs); native calls {calls}")
    prof = cProfile.Profile()
    prof.runcall(host_half, blocks, shape3d, axis_name)
    stats = pstats.Stats(prof)
    for (fname, line, func), (_, ncalls, tottime, cumtime, _) in sorted(
            stats.stats.items(), key=lambda kv: -kv[1][2])[:8]:
        print(f"  {tottime:8.3f} s self {cumtime:8.3f} s cum x{ncalls:<7d} "
              f"{Path(fname).name}:{line} {func}")


def phase_breakdown(model, vol):
    """Where the stack main path's time goes (``--profile``): the engine
    alone (device pipeline + one packed copy per block, no host
    matching), the model forward and the postprocess of one block, and a
    torch.profiler trace of the engine pass (device busy time by
    kernel), and the host half alone, native beside numpy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from empanada_torch.data import VolumeDataset

    engine = make_engine(model)
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
            torch.tensor([512, 512], dtype=torch.int32, device="cuda"),
            table), reps=5, warmup=2)
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

    blocks = [(z, pan.shape[-2:], np.asarray(packed))
              for z, pan, packed in engine.infer_blocks(dataset)]
    host_half_breakdown("breakdown", blocks, vol.shape, "xy", vol.shape[0])


def phase_breakdown_orthoplane(model, vol):
    """Each axis of the orthoplane path on its own (``--profile``): the
    engine alone over the axis's slices (no host matching), the model
    forward of one block of that shape, and the axis's host half alone
    (serial; native beside numpy, then the native one under cProfile).
    Held beside the overlapped run's per-axis times, these show how far
    the host threads slow the next axis's device stream."""
    import torch

    from empanada_torch.data import VolumeDataset

    engine = make_engine(model)
    for axis, name in enumerate(AXES):
        dataset = VolumeDataset(vol, axis=axis)
        n = len(dataset)

        def engine_pass():
            out = [(z, pan.shape[-2:], np.asarray(packed))
                   for z, pan, packed in engine.infer_blocks(dataset)]
            torch.cuda.synchronize()
            return out

        engine_pass()  # warm
        t0 = time.time()
        blocks = engine_pass()
        engine_s = time.time() - t0
        ph, pw = blocks[0][1]
        bsz = len(blocks[0][0])
        x = torch.from_numpy(np.random.default_rng(5).normal(
            0, 1, (bsz, 1, ph, pw)).astype(np.float32)).cuda()
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(x, interpolate_ins=False), reps=5,
                             warmup=2)
        print(f"breakdown orthoplane {name}: {n} slices padded to {ph}x{pw} "
              f"in {len(blocks)} blocks of {bsz}: engine alone "
              f"{engine_s:.3f} s = {n / engine_s:.2f} slices/s; "
              f"model forward {fwd_ms:.3f} ms per block")
        host_half_breakdown(f"breakdown orthoplane {name}", blocks,
                            vol.shape, name, n)


def same_instances(a, b):
    """Same labels, boxes, starts and runs."""
    return list(a) == list(b) and all(
        tuple(a[k]["box"]) == tuple(b[k]["box"])
        and np.array_equal(a[k]["starts"], b[k]["starts"])
        and np.array_equal(a[k]["runs"], b[k]["runs"]) for k in a)


def phase_content(mode):
    """Synthetic model on an ellipsoid, in stack or orthoplane mode
    (pixel_vote_thr 2): CUDA == CPU exactly, and the instance is the
    ellipsoid."""
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.synthetic import SyntheticModule

    shape = (12, 32, 32)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    vol = (((zz - 6.0) ** 2 / 16 + (yy - 15.0) ** 2 / 64
            + (xx - 16.0) ** 2 / 49) <= 1.0).astype(np.float32)
    kwargs = dict(labels=[1], thing_list=[1], mode=mode, qlen=3,
                  label_divisor=100, block_size=4, padding_factor=16,
                  max_centers=64, min_size=4, min_span=1, progress=False,
                  pixel_vote_thr=2)
    gpu = run_inference3d(SyntheticModule(), vol, device="cuda", **kwargs)
    cpu = run_inference3d(SyntheticModule(), vol, device="cpu", **kwargs)
    ins_g, ins_c = gpu[1].instances, cpu[1].instances
    if not ins_c:
        fail(f"content ({mode}): no instance found")
    if not same_instances(ins_g, ins_c):
        fail(f"content ({mode}): the CUDA instances (labels "
             f"{sorted(ins_g)}) differ from the CPU's ({sorted(ins_c)})")
    truth = np.flatnonzero(vol.reshape(-1) > 0.5)
    best = 0.0
    for attrs in ins_g.values():
        vox = np.concatenate([np.arange(s, s + r) for s, r in
                              zip(attrs["starts"], attrs["runs"])])
        inter = len(np.intersect1d(vox, truth))
        best = max(best, inter / (len(vox) + len(truth) - inter))
    print(f"content ({mode}): {len(ins_g)} instance(s), CUDA == CPU "
          f"exactly, IoU with the ellipsoid {best:.4f}")
    if best < 0.9:
        fail(f"content ({mode}): best IoU with the ellipsoid {best:.4f} "
             f"< 0.9")

# ---------------------------------------------------------------------------
# the training path: MitoNet's recipe at full width
# ---------------------------------------------------------------------------

RECIPE = "configs/mitonet_panoptic_bifpn_pointrend.yaml"
FINETUNE_RECIPE = "configs/finetune.yaml"
TRAIN_SET = {"train": (200, 120), "eval": (8,), "finetune": (48,)}
TRAIN_SIDE = 384
TRAIN_DEVICE = "cuda"


def em_like_image(rng, side=TRAIN_SIDE):
    """A seeded uint8 EM-like image (noisy background, bright rotated
    ellipses with dark membranes) and its uint16 instance mask."""
    image = rng.normal(110, 18, (side, side)).astype(np.float32)
    mask = np.zeros((side, side), np.uint16)
    for k in range(1, int(rng.integers(6, 16)) + 1):
        cy, cx = rng.uniform(0, side, 2)
        a, b = rng.uniform(10, 40), rng.uniform(6, 18)
        t = rng.uniform(0, np.pi)
        # the ellipse's bounding box only
        y0, y1 = int(max(cy - a, 0)), int(min(cy + a + 1, side))
        x0, x1 = int(max(cx - a, 0)), int(min(cx + a + 1, side))
        yy, xx = np.ogrid[y0:y1, x0:x1]
        u = ((yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)) / a
        v = (-(yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)) / b
        r = u * u + v * v
        inside = r <= 1
        mask[y0:y1, x0:x1][inside] = k
        patch = image[y0:y1, x0:x1]
        patch[inside] = 185 + rng.normal(0, 12, int(inside.sum()))
        patch[inside & (r > 0.8)] = 70
    return np.clip(image, 0, 255).astype(np.uint8), mask


def write_training_set(root):
    """The on-disk layout <dir>/<subdir>/{images,masks}/*.png of a train
    set (two subdirectories of unequal size), an eval set and a finetune
    set; returns their directories."""
    from empanada_torch.data.image_files import write_png

    rng = np.random.default_rng(5)
    dirs = {}
    for name, counts in TRAIN_SET.items():
        dirs[name] = root / name
        for si, n in enumerate(counts):
            for sub in ("images", "masks"):
                (dirs[name] / f"source{si}" / sub).mkdir(parents=True)
            for i in range(n):
                image, mask = em_like_image(rng)
                write_png(str(dirs[name] / f"source{si}" / "images"
                              / f"{i:04d}.png"), image)
                write_png(str(dirs[name] / f"source{si}" / "masks"
                              / f"{i:04d}.png"), mask)
    return dirs


def recipe_config(dirs, tmp, epochs):
    """The MitoNet recipe with only the data dirs, the epochs and the
    workers changed."""
    from empanada_torch.config import load_config

    cfg = load_config(RECIPE)
    cfg["TRAIN"].update(train_dir=str(dirs["train"]),
                        model_dir=str(tmp / "models"), workers=7)
    cfg["TRAIN"]["schedule_params"]["epochs"] = epochs
    cfg["EVAL"]["eval_dir"] = str(dirs["eval"])
    return cfg


def steady_rates(timeline, batch):
    """(steps/s, images/s, data-wait share, steps counted) over the
    steps after the first two, leaving out the first step of each later
    epoch (it holds the validation, the checkpoint and the new workers'
    start)."""
    rows = [(t["end"] - timeline[i - 1]["end"], t["data_wait"])
            for i, t in enumerate(timeline)
            if i >= 2 and t["epoch"] == timeline[i - 1]["epoch"]]
    seconds = sum(r[0] for r in rows)
    return (len(rows) / seconds, len(rows) * batch / seconds,
            sum(r[1] for r in rows) / seconds, len(rows))


def phase_train(dirs, tmp):
    """The recipe at full width on the card: 2 epochs with validation
    after each and a checkpoint, a validation of its own, then a resume
    for a third epoch. Returns (K1 launches of the fit, of the
    validation, the checkpoint, the config)."""
    import torch

    from empanada_torch.data.image_files import reader
    from empanada_torch.ops import group
    from empanada_torch.train import Trainer

    cfg = recipe_config(dirs, tmp, epochs=2)
    trainer = Trainer(cfg, device=TRAIN_DEVICE, seed=0)
    loader = trainer.build_loader()
    losses = []

    def on_step(trainer, aux):
        torch.cuda.synchronize()
        losses.append(float(aux["total_loss"]))

    print(f"training set: {len(loader.dataset)} images of {TRAIN_SIDE}² in "
          f"{len(TRAIN_SET['train'])} subdirectories "
          f"{TRAIN_SET['train']}, read with {reader()}; batch "
          f"{trainer.batch_size}, {len(loader)} steps an epoch, "
          f"{loader.num_workers} workers, amp {trainer.amp_dtype}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    group.reset_launches()
    t0 = time.time()
    trainer.fit(loader=loader, on_step=on_step)
    torch.cuda.synchronize()
    fit_seconds = time.time() - t0
    fit_launches = group.LAUNCHES["group_pixels"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_s, images_s, wait, counted = steady_rates(trainer.timeline,
                                                    trainer.batch_size)
    print(f"train: {len(losses)} steps in {fit_seconds:.3f} s (2 epochs, "
          f"validation and checkpoint after each); steady {steps_s:.4f} "
          f"steps/s = {images_s:.2f} images/s over {counted} steps; "
          f"data-wait share {wait:.4f}; peak device memory {peak:.3f} GiB; "
          f"K1 launches {fit_launches}")
    print("train losses per step: " + " ".join(f"{v:.5f}" for v in losses))
    print("train step seconds: " + " ".join(
        f"{t['end'] - (trainer.timeline[i - 1]['end'] if i else t0):.4f}"
        for i, t in enumerate(trainer.timeline)))
    if len(losses) < 10 or not np.isfinite(losses).all():
        fail(f"training: {len(losses)} steps, losses {losses}")
    if fit_launches <= 0:
        fail("the training path never launched the group_pixels kernel")

    group.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = trainer.validate()
    torch.cuda.synchronize()
    val_seconds = time.time() - t0
    val_launches = group.LAUNCHES["group_pixels"]
    print(f"validation: {TRAIN_SET['eval'][0]} images of {TRAIN_SIDE}² in "
          f"{val_seconds:.3f} s; metrics {metrics}; K1 launches "
          f"{val_launches}")
    if set(metrics) != {"mito_semantic_iou", "mito_pq", "mito_f1_50"} \
            or val_launches != 2 * TRAIN_SET["eval"][0]:
        fail(f"validation: metrics {sorted(metrics)}, K1 launches "
             f"{val_launches}")

    ckpt = trainer.checkpoint_path()
    if not (Path(ckpt).exists() and Path(ckpt + ".json").exists()):
        fail(f"no checkpoint at {ckpt}")
    del trainer, loader
    torch.cuda.empty_cache()

    resumed_cfg = recipe_config(dirs, tmp, epochs=3)
    resumed_cfg["TRAIN"]["resume"] = ckpt
    resumed = Trainer(resumed_cfg, device=TRAIN_DEVICE, seed=0)
    history = resumed.fit(on_step=lambda *a: None)
    print(f"resume: from epoch {resumed.start_epoch} to 3, "
          f"{len(history)} epoch, step {resumed.step}; last losses "
          f"{history[-1]}")
    if resumed.start_epoch != 2 or len(history) != 1 \
            or not np.isfinite(list(history[-1].values())).all():
        fail("resume: the epoch did not advance from the checkpoint")
    del resumed
    torch.cuda.empty_cache()
    return fit_launches, val_launches, ckpt, cfg


def run_command(args, label):
    """python -m empanada_torch <args> from the checkout; fails on a
    non-zero exit. Returns (its seconds, its standard output)."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "empanada_torch", *args],
                          capture_output=True, text=True, timeout=600)
    seconds = time.time() - t0
    tail = "\n".join(proc.stdout.strip().splitlines()[-4:])
    print(f"{label}: python -m empanada_torch {args[0]} in {seconds:.3f} s"
          f"\n{tail}")
    if proc.returncode != 0:
        fail(f"{label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return seconds, proc.stdout


def phase_export(cfg, ckpt, tmp):
    """The checkpoint exported by the command line; the descriptor's
    weights equal the checkpoint's."""
    import torch
    import yaml

    cfg_path = tmp / "mitonet_recipe.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    run_command(["export", str(cfg_path), ckpt, str(tmp / "export"),
                 "-name", "mitonet_trained"], "export")
    desc_path = tmp / "export" / "mitonet_trained.yaml"
    state = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    exported = torch.load(tmp / "export" / "mitonet_trained.pth",
                          map_location="cpu", weights_only=True)
    if sorted(state) != sorted(exported) or not all(
            torch.equal(state[k], exported[k]) for k in state):
        fail("export: the descriptor's weights differ from the checkpoint")
    return desc_path


def _batch_for_step(seed, n=2, side=128):
    from empanada_torch.data.utils.target_creation import heatmap_and_offsets

    rng = np.random.default_rng(seed)
    images, masks = zip(*(em_like_image(rng, side) for _ in range(n)))
    masks = np.stack(masks).astype(np.int64)
    hm, off = zip(*(heatmap_and_offsets(m) for m in masks))
    image = (np.stack(images)[..., None] / 255.0 - 0.5) / 0.15
    return {"image": image.astype(np.float32),
            "sem": (masks > 0).astype(np.float32),
            "ctr_hmp": np.stack(hm), "offsets": np.stack(off)}


def phase_step_parity(cfg):
    """One f32 train step of the recipe's model at full width (batch 2 x
    128², TF32 off) on the card and on the CPU from the same init, batch
    and PointRend points. Held: the loss within 1e-4 relative; the
    gradient tree within 1e-3 relative in L2 norm; each updated
    parameter within 1e-4 of max(its leaf's max |value|, 1) plus
    lr * |s_card - s_cpu|, s = g / (|g| + eps) from each side's own
    gradient: AdamW's first step moves an element by about lr * s, so
    an element whose gradient is float noise (or changes sign between
    the two devices) may move by up to 2 lr. Then the same step under
    bf16 autocast, its loss printed beside the f32 loss."""
    import copy

    import torch

    from empanada_torch.train import Trainer

    cfg = copy.deepcopy(cfg)
    cfg["TRAIN"]["batch_size"] = 2
    batch = _batch_for_step(9)
    coords = torch.from_numpy(np.random.default_rng(10).random(
        (2, cfg["MODEL"]["train_num_points"], 2)).astype(np.float32))
    results = {}
    for label, device, amp in (("cuda f32", TRAIN_DEVICE, False),
                               ("cpu f32", "cpu", False),
                               ("cuda bf16", TRAIN_DEVICE, True)):
        trainer = Trainer(cfg, device=device, seed=0)
        if not amp:
            trainer.amp_dtype = None
        trainer.init_state(5)
        t0 = time.time()
        aux = trainer.train_step(batch, point_coords=coords.to(device))
        loss = float(aux["total_loss"])
        results[label] = (loss, time.time() - t0, {
            n: (p.detach().cpu(), p.grad.detach().cpu())
            for n, p in trainer.model.named_parameters()},
            trainer.lr_schedule(0))
        del trainer
        torch.cuda.empty_cache()

    (gpu_loss, gpu_s, gpu, lr), (cpu_loss, cpu_s, cpu, _) = \
        results["cuda f32"], results["cpu f32"]
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    top = max(float(g.abs().max()) for _, g in cpu.values())
    num = den = 0.0
    worst_leaf = (0.0, "")
    worst_param = 0.0
    flipped = 0
    bad = []
    for name, (p_cpu, g_cpu) in cpu.items():
        p_gpu, g_gpu = gpu[name]
        num += float((g_gpu - g_cpu).square().sum())
        den += float(g_cpu.square().sum())
        err = float((g_gpu - g_cpu).abs().max()) \
            / max(float(g_cpu.abs().max()), 0.05 * top)
        worst_leaf = max(worst_leaf, (err, name))
        s_gpu, s_cpu = (g / (g.abs() + 1e-8) for g in (g_gpu, g_cpu))
        flipped += int((torch.sign(g_gpu) != torch.sign(g_cpu)).sum())
        atol = 1e-4 * max(float(p_cpu.abs().max()), 1.0) \
            + lr * (s_gpu - s_cpu).abs()
        ratio = float(((p_gpu - p_cpu).abs() / atol).max())
        worst_param = max(worst_param, ratio)
        if ratio > 1:
            bad.append(name)
    grad_rel = (num / den) ** 0.5
    n_elems = sum(p.numel() for p, _ in cpu.values())
    print(f"f32 step at full width, batch 2 x 128², TF32 off: loss card "
          f"{gpu_loss:.7f} / CPU {cpu_loss:.7f} (rel {rel:.2e}); gradient "
          f"tree rel L2 {grad_rel:.2e}; worst leaf {worst_leaf[0]:.2e} of "
          f"max(its max, 5% of the top leaf's) ({worst_leaf[1]}); "
          f"{flipped} of {n_elems} gradient elements change sign; worst "
          f"parameter {worst_param:.3f} of its tolerance; step seconds "
          f"card {gpu_s:.3f} (first call) / CPU {cpu_s:.3f}")
    bf16_loss = results["cuda bf16"][0]
    print(f"bf16 step (autocast) loss {bf16_loss:.7f} beside f32 "
          f"{gpu_loss:.7f}: rel {abs(bf16_loss - gpu_loss) / gpu_loss:.2e}")
    if rel > 1e-4 or grad_rel > 1e-3 or bad or not np.isfinite(bf16_loss):
        fail(f"f32 step: the card disagrees with the CPU (loss rel "
             f"{rel:.2e}, gradient rel L2 {grad_rel:.2e}, parameters "
             f"{bad[:5]}), or the bf16 loss is not finite")


ENCODER_FROZEN = ("encoder_mod.stem.", "encoder_mod.stage1_",
                  "encoder_mod.stage2_", "encoder_mod.stage3_")


def phase_finetune(desc_path, dirs, tmp):
    """``python -m empanada_torch finetune`` with the finetune recipe's
    TRAIN (stage4, batch 16) on the exported descriptor; stem and stages
    1-3 bit-identical, stage4, decoder and heads changed, the frozen BN
    statistics moved; the re-exported descriptor runs stack inference
    on the card. Returns the K1 launches of that inference."""
    import torch
    import yaml

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.config import load_config
    from empanada_torch.export import load_exported_model
    from empanada_torch.ops import group

    ft = load_config(FINETUNE_RECIPE)
    ft["MODEL"]["config"] = str(desc_path)
    ft["TRAIN"].update(train_dir=str(dirs["finetune"]),
                       model_dir=str(tmp / "finetuned"), logging=False)
    ft["TRAIN"]["schedule_params"]["epochs"] = 1
    ft_path = tmp / "finetune.yaml"
    with open(ft_path, "w") as f:
        yaml.safe_dump(ft, f)
    run_command(["finetune", str(ft_path)], "finetune")

    before = torch.load(str(desc_path).replace(".yaml", ".pth"),
                        weights_only=True)
    out_desc = tmp / "finetuned" / "finetune_finetuned.yaml"
    after = torch.load(str(out_desc).replace(".yaml", ".pth"),
                       weights_only=True)
    stats = ("running_mean", "running_var", "num_batches_tracked")
    frozen = [k for k in before if k.startswith(ENCODER_FROZEN)
              and not k.endswith(stats)]
    moved = [k for k in before if not k.startswith(ENCODER_FROZEN)
             and not k.endswith(stats)]
    if not all(torch.equal(before[k], after[k]) for k in frozen):
        fail("finetune: a frozen parameter (stem, stages 1-3) changed")
    changed = [k for k in moved if not torch.equal(before[k], after[k])]
    frozen_stats = [k for k in before if k.startswith(ENCODER_FROZEN)
                    and k.endswith("running_var")]
    stats_moved = sum(not torch.equal(before[k], after[k])
                      for k in frozen_stats)
    print(f"finetune: {len(frozen)} frozen parameters bit-identical; "
          f"{len(changed)} of {len(moved)} others changed "
          f"(stage4, decoder, heads); {stats_moved} of {len(frozen_stats)} "
          f"frozen BN running variances moved")
    for prefix in ("encoder_mod.stage4_", "semantic_decoder.",
                   "semantic_head.", "ins_center.", "semantic_pr."):
        if not any(k.startswith(prefix) for k in changed):
            fail(f"finetune: nothing under {prefix} changed")
    if stats_moved != len(frozen_stats):
        fail("finetune: the frozen stages' BN statistics did not move")

    model, desc = load_exported_model(str(out_desc), device=TRAIN_DEVICE)
    vol = em_like_volume(np.random.default_rng(11), 8, 256, 256, 12)
    group.reset_launches()
    result = run_inference3d(model, vol, labels=desc["labels"],
                             thing_list=desc["thing_list"], mode="stack",
                             norms=desc["norms"], device=TRAIN_DEVICE,
                             progress=False)
    launches = group.LAUNCHES["group_pixels"]
    if sorted(result) != [1] or result[1].shape3d != vol.shape \
            or launches <= 0:
        fail(f"finetuned descriptor: stack inference returned "
             f"{sorted(result)}, K1 launches {launches}")
    print(f"finetuned descriptor: stack inference on {vol.shape}, "
          f"{len(result[1].instances)} 3D instances, K1 launches {launches}")
    return launches


def phase_training(root):
    """The training path (see phase_train) and the commands around it.
    Returns its K1 launch counts by part and the training set's
    directories."""
    import torch

    import importlib

    found = {}
    for name in ("cv2", "imageio", "PIL"):
        try:
            found[name] = importlib.import_module(name).__version__
        except ImportError:
            found[name] = "not installed"
    print(f"image libraries: {found}")
    t0 = time.time()
    dirs = write_training_set(root)
    print(f"wrote the synthetic training, eval and finetune sets in "
          f"{time.time() - t0:.2f} s")
    fit_launches, val_launches, ckpt, cfg = phase_train(dirs, root)
    desc_path = phase_export(cfg, ckpt, root)
    stack_launches = phase_finetune(desc_path, dirs, root)
    torch.cuda.empty_cache()
    phase_step_parity(cfg)
    return {"train_fit": fit_launches, "train_validation": val_launches,
            "finetuned_stack": stack_launches}, dirs



# ---------------------------------------------------------------------------
# the Panoptic-DeepLab and boundary-contour families at full width
# ---------------------------------------------------------------------------

PDL_RECIPE = "configs/panoptic_deeplab_pointrend.yaml"
BC_RECIPE = "configs/panoptic_deeplab_bc.yaml"
# synthetic_em_volume's ground truth for both families' volume
# (ORTHO_SHAPE): disjoint dark ellipsoids on noise
SYNTH_GT = dict(n_instances=60, seed=12, radius=(6, 24), overlap=False)
CROP = (slice(0, 40), slice(0, 100), slice(0, 150))
# the watershed held against its numpy plain version: numpy takes
# ~6 s for this size on a host CPU
WATERSHED_SHAPE = (64, 128, 128)
WATERSHED_KW = dict(thres1=0.7, thres2=0.4, thres3=0.3, seed_thres=8,
                    min_size=32, label_divisor=1000)


def recipe_model(path, arch=None):
    """(arch, MODEL kwargs) of a recipe, its BASE chain resolved, without
    its ``dtype``: these phases hold the card against the CPU in float32,
    the parity mode (the recipes' bfloat16 runs in phases 15-17)."""
    from empanada_torch.config import load_config

    cfg = dict(load_config(path)["MODEL"])
    cfg.pop("dtype", None)
    recipe_arch = cfg.pop("arch")
    return arch or recipe_arch, cfg


def forward_parity(label, model, arch, cfg, x):
    """A full-width model's eval forward on the card against the CPU on
    the same weights and input (TF32 off): worst max |diff| / max |ref|
    over its outputs; fails above 1e-3 or on non-finite values."""
    import torch

    from empanada_torch.models import create_model

    with torch.inference_mode():
        got = {k: v.float().cpu() for k, v in model(x.cuda()).items()}
        cpu_model = create_model(arch, device="cpu", **cfg)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        want = cpu_model(x)
    worst = 0.0
    for key, r in want.items():
        a = got[key]
        if a.shape != r.shape or not torch.isfinite(a).all():
            fail(f"{label} output {key}: shape {tuple(a.shape)} or "
                 f"non-finite values")
        worst = max(worst, float((a - r).abs().max()
                                 / r.abs().max().clamp(min=1e-12)))
    print(f"{label} forward, CUDA vs CPU on {tuple(x.shape)}: outputs "
          f"{sorted(want)}, worst max |diff| / max |ref| = {worst:.2e}")
    if worst > 1e-3:
        fail(f"{label}: the CUDA forward disagrees with the CPU "
             f"({worst:.2e} > 1e-3 of max |value|)")


def gt_json(path, gt, label_divisor=1000):
    """A ground-truth label volume as a tracker JSON (class 1)."""
    from empanada_torch.cli.evaluate3d_bc import seg_to_tracker

    labels = gt.astype(np.int64)
    seg_to_tracker(labels + (labels > 0) * label_divisor,
                   label_divisor=label_divisor).write_to_json(str(path))
    return str(path)


def write_crop(path, vol):
    from empanada_torch.data.zarr_store import create_zarr

    store = create_zarr(str(path), vol.shape, dtype=np.uint8)
    store[:, :, :] = vol
    return str(path)


def phase_pdl(tmp):
    """PanopticDeepLabPR from the recipe's MODEL block (resnet50, stage 4
    at stride 16, decoder 256, ASPP 2/4/6, instance decoder at 0.5,
    PointRend) at full width from a seeded init: its parameter count;
    PDL, PDL-PR and PDL-BC forwards CUDA vs CPU; the orthoplane path on
    synthetic_em_volume(ORTHO_SHAPE) (slices/s, K1 launches per axis,
    host-core calls); ``evaluate3d`` on a crop against its ground truth;
    the ground truth scored against itself. Returns (the volume, its
    ground truth, K1 launches by path)."""
    import torch

    from empanada_torch.cli import evaluate3d
    from empanada_torch.core import native
    from empanada_torch.data.synthetic import synthetic_em_volume
    from empanada_torch.evaluation.evaluator import default_evaluator
    from empanada_torch.export import export_model
    from empanada_torch.models import create_model
    from empanada_torch.ops import group

    arch, cfg = recipe_model(PDL_RECIPE)
    model = create_model(arch, device="cuda", seed=0, **cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{arch} ({cfg['encoder']}, stage4_stride {cfg['stage4_stride']}, "
          f"decoder {cfg['decoder_channels']}, low-level stages "
          f"{cfg['low_level_stages']} -> {cfg['low_level_channels_project']}"
          f", ASPP rates {cfg['atrous_rates']}, instance decoder "
          f"{cfg['ins_decoder']} at {cfg['ins_ratio']}): {n_params} "
          f"parameters")
    x = torch.from_numpy(np.random.default_rng(13).normal(
        0, 1, (2, 1, 128, 128)).astype(np.float32))
    forward_parity(arch, model, arch, cfg, x)
    for other in ("PanopticDeepLab", "PanopticDeepLabBC"):
        other_model = create_model(other, device="cuda", seed=0, **cfg)
        forward_parity(other, other_model, other, cfg, x)
        del other_model
    torch.cuda.empty_cache()

    t0 = time.time()
    vol, gt = synthetic_em_volume(ORTHO_SHAPE, **SYNTH_GT)
    print(f"synthetic_em_volume{ORTHO_SHAPE}: {len(np.unique(gt)) - 1} "
          f"ground-truth instances, {time.time() - t0:.2f} s")
    kwargs = inference_kwargs("orthoplane")
    warm_axes(model, vol, kwargs, "pdl orthoplane")
    result, _, _, launches = timed_orthoplane(model, vol, kwargs,
                                              "pdl orthoplane")

    export_model(model.state_dict(), dict(cfg, arch=arch),
                 str(tmp / "pdl"), "pdl_pr", norms=NORMS)
    crop_path = write_crop(tmp / "pdl_crop.zarr", vol[CROP])
    truth = gt_json(tmp / "pdl_gt.json", gt[CROP])
    group.reset_launches()
    native.reset_calls()
    t0 = time.time()
    results = evaluate3d.main([str(tmp / "pdl" / "pdl_pr.yaml"), crop_path,
                               truth, "-out-dir", str(tmp / "eval3d")])
    seconds = time.time() - t0
    eval_launches = group.LAUNCHES["group_pixels"]
    host_path_ran("evaluate3d", HOST_REQUIRED)
    print(f"evaluate3d on the {vol[CROP].shape} crop in {seconds:.3f} s "
          f"(model load included), K1 launches {eval_launches}: " + ", ".join(
              f"{k} {float(v):.4f}" for k, v in results.items()))
    if eval_launches <= 0 or set(results) != set(
            default_evaluator()(truth, truth)):
        fail(f"evaluate3d: K1 launches {eval_launches}, metrics "
             f"{sorted(results)}")

    self_scores = default_evaluator()(truth, truth)
    print("ground truth against itself: " + ", ".join(
        f"{k} {float(v)!r}" for k, v in self_scores.items()))
    # PQ's segmentation quality divides by tp + 1e-5 (the reference's
    # epsilon), so it reaches 1 - 1e-5 / tp, not 1.0
    for name, value in self_scores.items():
        if (name != "pq" and float(value) != 1.0) or \
                abs(float(value) - 1.0) > 1e-4:
            fail(f"the ground truth against itself: {name} = {value}")
    del model, result
    torch.cuda.empty_cache()
    return vol, gt, {"pdl_orthoplane": launches["total"],
                     "pdl_orthoplane_by_axis": launches["per_axis"],
                     "evaluate3d": eval_launches}


def watershed_stacks(shape, seed=3):
    """uint8 (2, Z, Y, X) semantic / contour stacks from
    synthetic_em_volume's ground truth: high semantic inside objects,
    high contour on their borders, plus noise."""
    from scipy.ndimage import gaussian_filter

    from empanada_torch.data.synthetic import synthetic_em_volume
    from empanada_torch.data.utils.target_creation import seg_to_instance_bd

    _, gt = synthetic_em_volume(shape, n_instances=40, seed=seed,
                                radius=(4, 14), overlap=False)
    rng = np.random.default_rng(seed)
    sem = gaussian_filter((gt > 0).astype(np.float32), 1.0) * 255
    cnt = gaussian_filter((seg_to_instance_bd(gt) > 0).astype(np.float32),
                          0.7) * 400
    return np.stack([np.clip(a + rng.normal(0, 8, shape), 0, 255)
                     .astype(np.uint8) for a in (sem, cnt)])


def ellipsoid_volume(shape=(24, 72, 64), n=3):
    """Float volume of n disjoint ellipsoids at 1 on 0 with noise, and
    their labels."""
    d, h, w = shape
    zz, yy, xx = np.mgrid[:d, :h, :w]
    labels = np.zeros(shape, np.uint32)
    for k in range(n):
        inside = ((zz - d / 2) / (d / 2.6)) ** 2 \
            + ((yy - h * (k + 0.5) / n) / (h / (2.4 * n))) ** 2 \
            + ((xx - w / 2) / (w / 3.0)) ** 2 <= 1
        labels[inside] = k + 1
    noise = np.random.default_rng(14).normal(0, 0.05, shape)
    return ((labels > 0) + noise).astype(np.float32), labels


def phase_bc(vol, gt, dirs, tmp):
    """PanopticDeepLabBC from the BC recipe at full width (seeded)
    through run_bc_inference3d(orthoplane) on the PDL phase's volume;
    the device watershed against the numpy one; the parameter-free BC
    twin CUDA vs CPU and scored against its ellipsoids; ``evaluate3d_bc``
    on the crop; one epoch of the BC recipe through Trainer.fit on the
    training phase's set (validation through BCEngine)."""
    import torch

    from empanada_torch.cli import evaluate3d_bc
    from empanada_torch.cli.evaluate3d_bc import (
        run_bc_inference3d,
        seg_to_tracker,
    )
    from empanada_torch.config import load_config
    from empanada_torch.data.zarr_store import open_zarr
    from empanada_torch.evaluation.evaluator import default_evaluator
    from empanada_torch.export import export_model
    from empanada_torch.inference.tracker import InstanceTracker
    from empanada_torch.inference.watershed import (
        bc_watershed,
        bc_watershed_numpy,
    )
    from empanada_torch.models import create_model
    from empanada_torch.synthetic import SyntheticBCModule
    from empanada_torch.train import Trainer

    arch, cfg = recipe_model(BC_RECIPE)
    model = create_model(arch, device="cuda", seed=0, **cfg)
    print(f"{arch} ({cfg['encoder']}): "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    kwargs = dict(norms=NORMS, device="cuda", progress=False)
    t0 = time.time()
    for axis in range(3):
        run_bc_inference3d(model, np.ascontiguousarray(
            np.moveaxis(vol, axis, 0)[:4]), mode="stack", **kwargs)
    torch.cuda.synchronize()
    print(f"bc warm-up (4 slices of each slice shape): "
          f"{time.time() - t0:.3f} s")
    stats = {}
    t0 = time.time()
    seg = run_bc_inference3d(model, vol, stats=stats, **kwargs)
    seconds = time.time() - t0
    flood = stats["watershed"]
    print(f"bc orthoplane: volume {vol.shape}, {sum(vol.shape)} slices in "
          f"{seconds:.3f} s = {sum(vol.shape) / seconds:.2f} slices/s; "
          f"per axis xy / xz / yz " + " / ".join(
              f"{stats[f'{a}_seconds']:.3f}" for a in AXES)
          + f" s; watershed (flood on the card) "
          f"{stats['watershed_seconds']:.3f} s, {flood['levels']} levels, "
          f"{flood['rounds']} rounds, {flood['checks']} checks; "
          f"{len(np.unique(seg)) - 1} 3D instances")
    if seg.shape != vol.shape:
        fail(f"bc orthoplane: labels of shape {seg.shape}")

    stacks = watershed_stacks(WATERSHED_SHAPE)
    t0 = time.time()
    want = bc_watershed_numpy(stacks, **WATERSHED_KW)
    numpy_s = time.time() - t0
    bc_watershed(stacks[:, :8], device="cuda", **WATERSHED_KW)  # warm
    torch.cuda.synchronize()
    flood = {}
    t0 = time.time()
    got = bc_watershed(stacks, device="cuda", stats=flood, **WATERSHED_KW)
    device_s = time.time() - t0
    print(f"watershed {WATERSHED_SHAPE} from synthetic ground truth: card "
          f"{device_s:.3f} s, numpy {numpy_s:.3f} s; {flood['levels']} "
          f"levels, {flood['rounds']} rounds, {flood['checks']} checks; "
          f"{len(np.unique(want)) - 1} instances; labels equal: "
          f"{np.array_equal(got, want)}")
    if got.dtype != want.dtype or not np.array_equal(got, want) \
            or len(np.unique(want)) < 2:
        fail("the device watershed's labels differ from the numpy one's, "
             "or it found no instance")

    twin_vol, twin_labels = ellipsoid_volume()
    twin_kw = dict(padding_factor=16, seg_thr=0.9, cnt_thr=0.3, fg_thr=0.5,
                   seed_thres=4, min_size=16, progress=False)
    on_card = run_bc_inference3d(SyntheticBCModule(), twin_vol,
                                 device="cuda", **twin_kw)
    on_cpu = run_bc_inference3d(SyntheticBCModule(), twin_vol, device="cpu",
                                **twin_kw)
    seg_to_tracker(on_card).write_to_json(str(tmp / "twin_pred.json"))
    scores = default_evaluator()(gt_json(tmp / "twin_gt.json", twin_labels),
                                 str(tmp / "twin_pred.json"))
    print(f"bc twin on {twin_vol.shape} ellipsoids: "
          f"{len(np.unique(on_card)) - 1} instances, CUDA == CPU "
          f"{np.array_equal(on_card, on_cpu)}; F1@0.5 {scores['f1_50']:.4f}"
          f", F1@0.75 {scores['f1_75']:.4f}, PQ {scores['pq']:.4f}")
    if not np.array_equal(on_card, on_cpu) or scores["f1_50"] != 1:
        fail("bc twin: the CUDA labels differ from the CPU's, or they miss "
             "an ellipsoid")

    export_model(model.state_dict(), dict(cfg, arch=arch), str(tmp / "bc"),
                 "pdl_bc", norms=NORMS)
    crop_path = write_crop(tmp / "bc_crop.zarr", vol[CROP])
    truth = gt_json(tmp / "bc_gt.json", gt[CROP])
    t0 = time.time()
    results = evaluate3d_bc.main([str(tmp / "bc" / "pdl_bc.yaml"),
                                  crop_path, truth, "-out-dir",
                                  str(tmp / "eval_bc")])
    seconds = time.time() - t0
    tracker = InstanceTracker()
    tracker.load_from_json(str(tmp / "eval_bc" / "pred_bc.json"))
    stored = np.asarray(open_zarr(str(tmp / "bc_crop_bc_seg.zarr")))
    if not np.array_equal(stored, dense_fill(stored.shape,
                                             tracker.instances)):
        fail("evaluate3d_bc: the _bc_seg.zarr store differs from a fill of "
             "pred_bc.json")
    print(f"evaluate3d_bc on the crop in {seconds:.3f} s (model load "
          f"included): {len(tracker.instances)} instances, _bc_seg.zarr == "
          f"fill of pred_bc.json; " + ", ".join(
              f"{k} {float(v):.4f}" for k, v in results.items()))
    del model
    torch.cuda.empty_cache()

    tcfg = load_config(BC_RECIPE)
    tcfg["TRAIN"].update(train_dir=str(dirs["train"]),
                         model_dir=str(tmp / "bc_models"), workers=7)
    tcfg["TRAIN"]["schedule_params"]["epochs"] = 1
    tcfg["EVAL"]["eval_dir"] = str(dirs["eval"])
    trainer = Trainer(tcfg, device="cuda", seed=0)
    loader = trainer.build_loader()
    losses = []

    def on_step(trainer, aux):
        torch.cuda.synchronize()
        losses.append(float(aux["total_loss"]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    history = trainer.fit(loader=loader, on_step=on_step)
    torch.cuda.synchronize()
    fit_seconds = time.time() - t0
    steps_s, images_s, wait, counted = steady_rates(trainer.timeline,
                                                    trainer.batch_size)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"bc train: {arch} ({cfg['encoder']}), {len(losses)} steps of "
          f"batch {trainer.batch_size} in {fit_seconds:.3f} s (1 epoch, "
          f"validation through {tcfg['EVAL']['engine']} and a checkpoint); "
          f"steady {steps_s:.4f} steps/s = {images_s:.2f} images/s over "
          f"{counted} steps; data-wait share {wait:.4f}; peak device memory "
          f"{peak:.3f} GiB; amp {trainer.amp_dtype}; last aux "
          f"{history[-1]}")
    print("bc train losses per step: " + " ".join(f"{v:.5f}"
                                                   for v in losses))
    if not losses or not np.isfinite(losses).all():
        fail(f"bc training: losses {losses}")
    metrics = trainer.validate()
    if list(metrics) != ["mito_semantic_iou"]:
        fail(f"bc validation: metrics {metrics}")
    del trainer, loader
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# model artifacts in and out, and the curation toolkit
# ---------------------------------------------------------------------------

# int8 tensor-core peak of one H100 SXM (NVIDIA data sheet, dense)
PEAK_INT8_OPS = 1979e12


def reference_layout(model):
    """The reference's torch layout of a port model's state: keys
    ``module.m{i}.weight`` / ``.bias`` / ``.weights`` (BiFPN fusion) and
    batch norms ``module.bn{i}.*`` with their running statistics, in the
    reference's registration order (``train.torch_weights``), PointRend's
    layers as Conv1d (out, in, 1), a ``fc.`` head the converters skip and
    the first BiFPN after-combine conv under two keys (one tensor)."""
    import torch

    from empanada_torch.train.torch_weights import _port_leaves

    params, stats = _port_leaves(model.state_dict())
    names, sd, aliased = {}, {}, False
    for path, (_, t) in params.items():
        mod, leaf = path[:-1], path[-1]
        in_bn = any("BatchNorm" in seg for seg in mod)
        names.setdefault(mod, f"{'bn' if in_bn else 'm'}{len(names)}")
        base = "module." + names[mod]
        v = t.detach().cpu().clone()
        if in_bn:
            sd[f"{base}.{'weight' if leaf == 'scale' else 'bias'}"] = v
            if leaf == "bias":
                for stat in ("mean", "var"):
                    sd[f"{base}.running_{stat}"] = \
                        stats[mod + (stat,)][1].detach().cpu().clone()
                sd[f"{base}.num_batches_tracked"] = torch.tensor(0)
            continue
        if leaf == "kernel" and v.ndim == 2:
            v = v[:, :, None]  # Linear -> the reference's Conv1d
        key = {"kernel": "weight", "fusion_weights": "weights"}.get(leaf,
                                                                     leaf)
        sd[f"{base}.{key}"] = v
        if not aliased and "after" in mod and leaf == "kernel":
            sd[f"{base}_shared.{key}"] = v
            aliased = True
    sd["module.fc.weight"] = torch.ones(2, 8)
    sd["module.fc.bias"] = torch.zeros(2)
    return sd


def torchscript_archive(sd, path):
    """torch.jit.save of a module tree whose state dict is ``sd``."""
    import torch
    from torch import nn

    root = nn.Identity()
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        m = root
        for name in mods:
            if not hasattr(m, name):
                m.add_module(name, nn.Identity())
            m = getattr(m, name)
        m.register_buffer(leaf, t)
    torch.jit.save(torch.jit.script(root), str(path))


def calibration_batches(vol, n=2, b=8):
    """n batches of b normalized xy slices of ``vol`` on the card, the
    factor-pad ring zero, as the engine feeds the model."""
    import torch

    from empanada_torch.ops.resize import factor_pad

    x = (vol[:n * b].astype(np.float32) / 255.0 - NORMS["mean"]) \
        / NORMS["std"]
    x, _ = factor_pad(x, 128)
    x = torch.from_numpy(np.ascontiguousarray(x)).cuda()[:, None]
    return [x[i * b:(i + 1) * b] for i in range(n)]


def encoder_conv_shapes(model, x):
    """{(input shape, weight shape, stride, padding, dilation, groups):
    calls} of the int8 convolutions of the encoder in one forward."""
    import torch

    from empanada_torch.export import FORWARD_KW
    from empanada_torch.models.quantization import Int8Conv2d

    shapes = {}

    def pre(module, args):
        key = (tuple(args[0].shape), tuple(module.weight_int8.shape),
               tuple(module.stride), tuple(module.padding),
               tuple(module.dilation), module.groups)
        shapes[key] = shapes.get(key, 0) + 1

    handles = [m.register_forward_pre_hook(pre)
               for name, m in model.named_modules()
               if isinstance(m, Int8Conv2d) and name.startswith("encoder")]
    with torch.inference_mode():
        model(x, **FORWARD_KW)
    for h in handles:
        h.remove()
    return shapes


# int8 conv shapes (input, weight) on which cuBLASLt refuses an int8
# product whose outer size is 8 modulo 16 (the card path pads it to 16)
INT8_EDGE_CONVS = [((24, 32, 128, 192), (168, 32, 1, 1)),
                   ((24, 40, 64, 96), (40, 40, 1, 1))]


def phase_int8_convs(model, x):
    """For every distinct int8 conv shape of the encoder at the main
    path's xy block: the card path (im2col + torch._int_mm) == the plain
    path (float64 convolution) exactly on seeded int8 operands; its time
    (CUDA events) beside cuDNN's float32 convolution of the same shape
    (TF32 off) and the bound (int8 bytes in, int32 out, at 3.35 TB/s; or
    the products at the int8 tensor-core peak). Returns the rows."""
    import torch
    import torch.nn.functional as F

    from empanada_torch.ops import int8

    shapes = encoder_conv_shapes(model, x)
    rows = []
    for i, ((xs, ws, s, p, d, g), calls) in enumerate(sorted(
            shapes.items())):
        gen = torch.Generator(device="cuda").manual_seed(i)
        xq = torch.randint(-127, 128, xs, dtype=torch.int8, device="cuda",
                           generator=gen)
        w8 = torch.randint(-127, 128, ws, dtype=torch.int8, device="cuda",
                           generator=gen)
        card = int8.int8_conv2d_card(xq, w8, s, p, d, g)
        plain = int8.int8_conv2d_plain(xq, w8, s, p, d, g)
        torch.cuda.synchronize()
        if card.dtype != torch.int32 or not torch.equal(card, plain):
            fail(f"int8 conv {xs} * {ws} stride {s} groups {g}: card path "
                 f"!= plain path")
        xf, wf = xq.float(), w8.float()
        ms = cuda_ms(lambda: int8.int8_conv2d_card(xq, w8, s, p, d, g),
                     reps=10)
        cudnn_ms = cuda_ms(lambda: F.conv2d(xf, wf, None, s, p, d, g),
                           reps=10)
        n_bytes = xq.numel() + w8.numel() + card.numel() * 4
        n_ops = 2 * card.numel() * ws[1] * ws[2] * ws[3]
        by_bytes = n_bytes / PEAK_BYTES * 1e3
        by_ops = n_ops / PEAK_INT8_OPS * 1e3
        row = {"x": list(xs), "w": list(ws), "stride": s[0],
               "dilation": d[0], "groups": g, "calls": calls, "ms": ms,
               "cudnn_f32_ms": cudnn_ms, "bound_ms": max(by_bytes, by_ops),
               "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
        rows.append(row)
        print(f"int8 conv {tuple(xs)} * {tuple(ws)} stride {s[0]} groups "
              f"{g} ({calls} call(s) a forward): card == plain exactly; "
              f"{ms:.4f} ms, cuDNN float32 {cudnn_ms:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    for xs, ws in INT8_EDGE_CONVS:
        xq = torch.randint(-127, 128, xs, dtype=torch.int8, device="cuda")
        w8 = torch.randint(-127, 128, ws, dtype=torch.int8, device="cuda")
        if not torch.equal(int8.int8_conv2d_card(xq, w8),
                           int8.int8_conv2d_plain(xq, w8)):
            fail(f"int8 conv {xs} * {ws}: card path != plain path")
        # the same 1x1 product unpadded, straight to cuBLASLt
        a = xq.permute(0, 2, 3, 1).reshape(-1, xs[1]).contiguous()
        try:
            torch._int_mm(a, w8.reshape(ws[0], -1).contiguous().t())
            torch.cuda.synchronize()
            raw = "accepts"
        except RuntimeError:
            raw = "refuses"
        print(f"int8 conv edge shape {xs} * {ws}: card == plain exactly; "
              f"torch._int_mm {raw} the unpadded ({a.shape[0]} x "
              f"{xs[1]}) @ ({xs[1]} x {ws[0]}) product")
    total = sum(r["ms"] * r["calls"] for r in rows)
    total_f32 = sum(r["cudnn_f32_ms"] * r["calls"] for r in rows)
    print(f"int8 encoder convs: {len(rows)} distinct shapes, "
          f"{sum(r['calls'] for r in rows)} calls a forward at {tuple(x.shape)}"
          f"; summed {total:.3f} ms int8 card path against {total_f32:.3f} "
          f"ms cuDNN float32")
    return rows


def phase_artifacts(vol, tmp):
    """Full-width MitoNet through the artifacts: a reference-layout
    TorchScript archive -> ``export --from-torch --quantize`` (imported
    state == source, bit for bit); a calibrated int8 export on the card
    (scope, paths, int8 products a forward, drift); float32 and int8
    orthoplane runs from the descriptor in this call; the encoder's int8
    conv shapes, card == plain; ``infer3d --quantized`` on a crop.
    Returns K1 launches by path."""
    import torch
    import yaml

    from empanada_torch.export import (
        FORWARD_KW,
        export_model,
        load_exported_model,
    )
    from empanada_torch.models import create_model
    from empanada_torch.export import INT8_SUFFIX
    from empanada_torch.models.quantization import (
        Int8Conv2d,
        Int8Linear,
        int8_conv_count,
    )

    tmp = Path(tmp) / "artifacts"
    tmp.mkdir()
    cfg = dict(MITONET)
    model = create_model(cfg.pop("arch"), device="cpu", seed=0, **cfg)
    state = model.state_dict()
    t0 = time.time()
    archive = tmp / "MitoNet_reference.pth"
    sd = reference_layout(model)
    torchscript_archive(sd, archive)
    print(f"reference-layout TorchScript archive of MitoNet: {len(sd)} "
          f"tensors, {archive.stat().st_size / 2 ** 20:.1f} MiB, "
          f"{time.time() - t0:.2f} s")
    recipe = tmp / "mitonet.yaml"
    with open(recipe, "w") as f:
        yaml.safe_dump({"MODEL": dict(MITONET),
                        "DATASET": {"labels": [1], "thing_list": [1],
                                    "class_names": {1: "mito"},
                                    "norms": NORMS}}, f)
    run_command(["export", str(recipe), str(archive), str(tmp / "imported"),
                 "--from-torch", "--quantize", "-name", "mitonet"],
                "export --from-torch --quantize")
    imported = torch.load(tmp / "imported" / "mitonet.pth",
                          weights_only=True)
    if sorted(imported) != sorted(state) or not all(
            torch.equal(imported[k], state[k]) for k in state):
        fail("export --from-torch: the imported state differs from the "
             "source")
    weight_only = torch.load(tmp / "imported" / "mitonet.int8.pth",
                             weights_only=True)
    n_w8 = sum(k.endswith(INT8_SUFFIX) for k in weight_only)
    print(f"export --from-torch --quantize: imported state == source bit "
          f"for bit ({len(state)} tensors); weight-only int8 artifact with "
          f"{n_w8} int8 weights")
    del model, imported, weight_only, sd

    batches = calibration_batches(vol)
    t0 = time.time()
    desc = export_model(state, MITONET, str(tmp), "mitonet_int8",
                        norms=NORMS, quantize=True,
                        calibration_data=batches, device="cuda")
    torch.cuda.synchronize()
    print(f"calibrated int8 export on 2 batches of {tuple(batches[0].shape)}"
          f" in {time.time() - t0:.2f} s: scope {desc['quantize_scope']}, "
          f"{len(desc['act_scales'])} calibrated paths, drift "
          f"{desc['int8_drift']}")
    desc_path = tmp / "mitonet_int8.yaml"
    model8, _ = load_exported_model(str(desc_path), quantized=True,
                                    device="cuda")
    n_mod = sum(isinstance(m, (Int8Conv2d, Int8Linear))
                for m in model8.modules())
    n_calls = int8_conv_count(model8, batches[0], **FORWARD_KW)
    print(f"int8 model: {n_mod} int8 modules, {n_calls} int8 products a "
          f"forward")
    if n_mod <= 0 or n_calls < n_mod:
        fail(f"the int8 model runs {n_calls} int8 products with {n_mod} "
             f"int8 modules")

    kwargs = inference_kwargs("orthoplane")
    model32, _ = load_exported_model(str(desc_path), device="cuda")
    rates, launches = {}, {}
    for label, m in (("float32", model32), ("int8", model8)):
        warm_axes(m, vol, kwargs, f"{label} orthoplane")
        _, _, seconds, launches[label] = timed_orthoplane(
            m, vol, kwargs, f"{label} orthoplane")
        rates[label] = sum(vol.shape) / seconds
    print(f"orthoplane from the descriptor, this call: float32 "
          f"{rates['float32']:.2f} slices/s, int8 {rates['int8']:.2f} "
          f"slices/s ({rates['int8'] / rates['float32']:.3f}x); K1 launches "
          f"by axis float32 {launches['float32']['per_axis']}, int8 "
          f"{launches['int8']['per_axis']}")
    del model32

    xy = GROUP_SHAPES["xy"][0]
    x = calibration_batches(vol, n=1, b=xy)[0]
    phase_int8_convs(model8, x)
    del model8, batches, x
    torch.cuda.empty_cache()

    crop = write_crop(tmp / "crop.zarr", vol[:40, :100, :150])
    _, out = run_command(["infer3d", str(desc_path), crop, "--quantized",
                          "-mode", "orthoplane"], "infer3d --quantized")
    seg = tmp / "crop_orthoplane_seg_class1.zarr"
    if "WARNING: int8 artifact (scope=encoder) measured drift" not in out \
            or not (seg / ".zarray").exists():
        fail("infer3d --quantized: no drift warning or no class zarr")
    print("infer3d --quantized: " + next(
        line for line in out.splitlines() if line.startswith("WARNING")))
    return {"int8_orthoplane": launches["int8"]["total"],
            "int8_orthoplane_by_axis": launches["int8"]["per_axis"]}


def quality_patches(n=1024, side=224, seed=21):
    """n seeded 224^2 crops of a synthetic EM volume."""
    from empanada_torch.data.synthetic import synthetic_em_volume

    vol, _ = synthetic_em_volume((16, 448, 448), n_instances=60, seed=seed,
                                 radius=(6, 24), overlap=False)
    rng = np.random.default_rng(seed)
    zs = rng.integers(0, vol.shape[0], n)
    ys, xs = (rng.integers(0, 448 - side, n) for _ in range(2))
    return [vol[z, y:y + side, x:x + side] for z, y, x in zip(zs, ys, xs)]


def _tree_files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def phase_curation(vol, gt, tmp):
    """``curate dedup`` on PNG slices of the synthetic volume (written
    patches == the source's pixels); PatchQualityFilter("resnet34") on
    the card over 1024 patches of 224^2 (images/s; CUDA scores against
    the CPU's on 32 of them); ``flipbooks``, ``split-stack``,
    ``merge-batch`` and ``group-dirs`` on the result, checking the trees
    they write."""
    import torch

    from empanada_torch.data import curation as cur
    from empanada_torch.data.image_files import read_tiff, write_png

    root = Path(tmp) / "curation"
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir()
    zs = range(0, vol.shape[0], 6)
    for z in zs:
        write_png(str(root / "images" / f"synth-LOC-{z}.png"), vol[z])
        write_png(str(root / "masks" / f"synth-LOC-{z}.png"),
                  gt[z].astype(np.uint16))
    run_command(["curate", "dedup", str(root / "images"),
                 str(root / "dedup"), "--mask-dir", str(root / "masks"),
                 "--crop-size", "128"], "curate dedup")
    kept = sorted((root / "dedup" / "synth" / "images").glob("*.tiff"))
    for path in kept:
        stem = path.stem  # synth-LOC-<z>-LOC-2d-<ys>-<ye>_<xs>-<xe>
        z = int(stem.split("-LOC-")[1])
        (ys, ye), (xs, xe) = (map(int, part.split("-")) for part in
                              stem.split("-LOC-2d-")[1].split("_"))
        if not np.array_equal(read_tiff(str(path)), vol[z, ys:ye, xs:xe]):
            fail(f"curate dedup: {path.name} differs from its source")
    n_masks = len(list((root / "dedup" / "synth" / "masks").glob("*.tiff")))
    print(f"curate dedup: {len(kept)} of {4 * len(zs)} patches kept from "
          f"{len(zs)} slices, {n_masks} masks; every written patch == its "
          f"source pixels")
    if not kept or n_masks != len(kept):
        fail("curate dedup wrote no patches, or not one mask a patch")

    patches = quality_patches()
    filt = cur.PatchQualityFilter("resnet34", device="cuda", seed=0)
    filt.predict(patches[:64])
    torch.cuda.synchronize()
    t0 = time.time()
    scores = filt.predict(patches, batch_size=64)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    xs = filt._prep(patches)
    with torch.inference_mode():
        batch = torch.from_numpy(xs[:64]).cuda()
        fwd_ms = cuda_ms(lambda: filt.model(batch), reps=10)
    cpu = cur.PatchQualityFilter("resnet34", device="cpu", state_dict={
        k: v.cpu() for k, v in filt.model.state_dict().items()})
    err = float(np.abs(cpu.predict(patches[:32]) - scores[:32]).max())
    keep, drop, _ = filt.filter(patches, float(np.median(scores)), 0.1)
    print(f"PatchQualityFilter(resnet34) on the card: {len(patches)} "
          f"patches of 224^2 in {seconds:.3f} s = "
          f"{len(patches) / seconds:.1f} images/s (host resize and "
          f"normalization included); the forward alone "
          f"{64 / fwd_ms * 1e3:.1f} images/s at batch 64; CUDA vs CPU "
          f"scores on 32 patches max |diff| {err:.2e} (tolerance 1e-4); "
          f"filter keeps {len(keep)}, rejects {len(drop)}")
    if not np.isfinite(scores).all() or err > 1e-4:
        fail(f"PatchQualityFilter: scores on the card disagree with the "
             f"CPU ({err:.2e}) or are not finite")

    np.save(root / "vol.npy", vol)
    ids = [i for i in np.unique(gt) if i][:6]
    centers = [[int(round(c)) for c in np.argwhere(gt == i).mean(axis=0)]
               for i in ids]
    with open(root / "locs.json", "w") as f:
        json.dump(centers, f)
    run_command(["curate", "flipbooks", str(root / "vol.npy"),
                 str(root / "locs.json"), str(root / "books.npy"),
                 "--span", "5", "--size", "96"], "curate flipbooks")
    books = np.load(root / "books.npy")
    if not np.array_equal(books, cur.flipbooks_from_locations(
            vol, centers, 5, 96)):
        fail("curate flipbooks: the books differ from the library's")
    masks = cur.flipbooks_from_locations(gt, centers, 5, 96)
    np.save(root / "books_img.npy", books.reshape(-1, 96, 96))
    np.save(root / "books_msk.npy", masks.reshape(-1, 96, 96))
    attrs = [{"image_name": f"{'synth' if i % 2 else 'other'}-ROI-{i}.png",
              "start": 5 * i, "end": 5 * i + 4, "median_confidence": 3 + i % 3,
              "height": 96, "width": 96} for i in range(len(centers))]
    with open(root / "attrs.json", "w") as f:
        json.dump(attrs, f)
    run_command(["curate", "split-stack", str(root / "books_img.npy"),
                 str(root / "books_msk.npy"), str(root / "attrs.json"),
                 str(root / "batch")], "curate split-stack")
    for i in range(len(centers)):
        name = attrs[i]["image_name"][:-4]
        image = read_tiff(str(root / "batch" / "images" / f"{name}.tiff"))
        if not np.array_equal(image, books[i, 2]):
            fail(f"curate split-stack: {name} is not its book's middle "
                 f"slice")
    run_command(["curate", "merge-batch", str(root / "batch"),
                 str(root / "train")], "curate merge-batch")
    with open(root / "conv.json", "w") as f:
        json.dump({"other": "synth"}, f)
    run_command(["curate", "group-dirs", str(root / "train"),
                 str(root / "conv.json")], "curate group-dirs")
    tree = _tree_files(root / "train")
    names = [a["image_name"][:-4] + ".tiff" for a in attrs]
    want = sorted(["synth/confidences.json"]
                  + [f"synth/{sub}/{n}" for n in names
                     for sub in ("images", "masks")]
                  + ["other/confidences.json"])
    with open(root / "train" / "synth" / "confidences.json") as f:
        conf = json.load(f)
    if tree != want or sorted(conf) != sorted(names):
        fail(f"curate: the training tree {tree} is not {want}")
    print(f"curate flipbooks -> split-stack -> merge-batch -> group-dirs: "
          f"{len(books)} books of (5, 96, 96); the training tree holds "
          f"{len(tree)} files, confidences for {len(conf)} images")


# ---------------------------------------------------------------------------
# phase 14: multi-device (the mesh engine, K1 on every card, multi-process
# inference, data-parallel training)
# ---------------------------------------------------------------------------

DDP_BATCH = 16
DDP_SIDE = 256


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(kind, world, out, *extra, local_ranks=None, timeout=600):
    """``world`` ranks of ``python3 chip_smoke.py --worker <kind> port
    rank world out *extra``; waits for all, kills what is left, fails on
    a non-zero exit. Returns the wall seconds and the NCCL transports
    that the ranks' NCCL_DEBUG=INFO lines name ("via P2P/IPC", ...)."""
    import os
    import re

    port = free_port()
    procs = []
    t0 = time.time()
    for rank in range(world):
        env = dict(os.environ, NCCL_DEBUG="INFO", LOCAL_RANK=str(
            rank if local_ranks is None else local_ranks[rank]))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             kind, str(port), str(rank), str(world), str(out),
             *map(str, extra)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    transports, errs = set(), []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(
                timeout=max(timeout - (time.time() - t0), 1))
            transports.update(re.findall(r" via (\S+)", stdout + stderr))
            if proc.returncode != 0:
                errs.append(f"rank {rank} exit {proc.returncode}: "
                            f"{stderr[-2500:]}")
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    if errs:
        fail(f"{kind} workers: " + "\n".join(errs))
    return time.time() - t0, sorted(transports)


def ddp_config():
    """The MitoNet recipe at full width for the parity step: the global
    batch of DDP_BATCH, float32 (the parity runs turn autocast off)."""
    from empanada_torch.config import load_config

    cfg = load_config(RECIPE)
    cfg["TRAIN"]["batch_size"] = DDP_BATCH
    return cfg


def ddp_inputs():
    """The seeded global batch (DDP_BATCH x DDP_SIDE^2) and PointRend
    points of the parity step."""
    import torch

    batch = _batch_for_step(31, n=DDP_BATCH, side=DDP_SIDE)
    coords = torch.from_numpy(np.random.default_rng(32).random(
        (DDP_BATCH, ddp_config()["MODEL"]["train_num_points"], 2))
        .astype(np.float32))
    return batch, coords


def worker_ddp(rank, world, out, backend, price):
    """One rank of the data-parallel parity step (float32, TF32 off) on
    its rows of the global batch, then timed bf16 steps and a profiled
    one, an all-reduce's latency (2 KiB) and time at the gradients' size
    (128 MiB); with ``price``, to price the collectives (measurements
    only, not the trainer's semantics), the same bf16 steps with torch's
    fused SyncBatchNorm, with the batch norm's all-reduces on a group of
    their own, with batch norm over each rank's rows, then the rank's
    step alone (no DDP, no collective). Rank 0 writes its step record,
    every rank its numbers. World 1 is one process without a group."""
    import pickle

    import torch
    import torch.distributed as dist

    from empanada_torch.entry import step_record
    from empanada_torch.parallel import initialize_distributed
    from empanada_torch.train import Trainer

    initialize_distributed(f"127.0.0.1:{PORT}", world, rank,
                           backend=backend)
    batch, coords = ddp_inputs()
    trainer = Trainer(ddp_config(), seed=0)
    trainer.amp_dtype = None
    trainer.init_state(5)
    b = DDP_BATCH // world
    rows = slice(rank * b, (rank + 1) * b)
    mine = {k: v[rows] for k, v in batch.items()}
    aux = trainer.train_step(mine, point_coords=coords[rows].to(
        trainer.device))
    if rank == 0:
        torch.save(step_record(trainer, aux), Path(out) / "ddp_step.pt")

    # bf16 steps on the same rows: images/s of the global batch, peak
    # memory, and one step under the profiler (collectives' share)
    trainer.amp_dtype = torch.bfloat16
    for _ in range(2):
        trainer.train_step(mine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if world > 1:
        dist.barrier()
    t0 = time.time()
    steps = 5
    for _ in range(steps):
        trainer.train_step(mine)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.time()
        trainer.train_step(mine)
        torch.cuda.synchronize()
        step_s = time.time() - t1
    coll_cpu = coll_dev = 0.0
    for ev in prof.key_averages():
        key = ev.key.lower()
        if "nccl" in key:
            coll_dev += device_us(ev) / 1e6
        elif any(s in key for s in ("allreduce", "all_reduce", "allgather",
                                    "all_gather", "gloo")):
            coll_cpu += ev.self_cpu_time_total / 1e6
    numbers = {"rank": rank, "images_s": steps * DDP_BATCH / seconds,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "step_s": step_s, "collective_device_s": coll_dev,
               "collective_host_s": coll_cpu, "device": str(trainer.device)}
    if world > 1:
        def all_reduce_ms(numel, reps):
            t = torch.ones(numel, device=trainer.device)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(reps):
                dist.all_reduce(t)
            torch.cuda.synchronize()
            return (time.time() - t0) / reps * 1e3

        numbers["all_reduce_2kib_ms"] = all_reduce_ms(512, 50)
        numbers["all_reduce_128mib_ms"] = all_reduce_ms(32 * 2 ** 20, 3)

    if world > 1 and price:
        from empanada_torch.models.blocks import set_sync_batchnorm

        def step_ms():
            trainer.train_step(mine)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.time()
            for _ in range(steps):
                trainer.train_step(mine)
            torch.cuda.synchronize()
            return (time.time() - t0) / steps * 1e3

        # the global batch norm priced two other ways: torch's fused
        # SyncBatchNorm kernels (fewer launches), and the per-layer
        # all-reduces on a process group of their own (not queued behind
        # DDP's gradient buckets)
        numbers["fused_bn_step_ms"] = fused_sync_bn_step_ms(step_ms)
        import torch.distributed.nn.functional as dfn

        own = dist.new_group()
        real = dfn.all_reduce
        dfn.all_reduce = lambda t, **kw: real(t, group=own)
        numbers["bn_group_step_ms"] = step_ms()
        dfn.all_reduce = real
        set_sync_batchnorm(trainer.model, 1)
        numbers["local_bn_step_ms"] = step_ms()
        trainer.ddp = trainer.criterion.global_batch = None
        trainer.points = trainer.points.generator
        numbers["alone_step_ms"] = step_ms()
    with open(Path(out) / f"ddp_rank{rank}.pkl", "wb") as f:
        pickle.dump(numbers, f)
    if world > 1:
        dist.destroy_process_group()


def fused_sync_bn_step_ms(step_ms):
    """step_ms() with FlaxBatchNorm2d's synchronized train mode through
    torch's SyncBatchNorm autograd function (batch_norm_stats, one
    all_gather, batch_norm_elemt; one all_reduce backward), the running
    variance moved by the biased global variance as flax's."""
    import torch
    import torch.distributed as dist
    from torch.nn.modules._functions import SyncBatchNorm

    from empanada_torch.models.blocks import FlaxBatchNorm2d

    def fused(self, x):
        rm, rv = self.running_mean.clone(), self.running_var.clone()
        y = SyncBatchNorm.apply(x, self.weight, self.bias, rm, rv, self.eps,
                                self.momentum, dist.group.WORLD,
                                self.sync_world)
        n = x.numel() // x.shape[1] * self.sync_world
        with torch.no_grad():
            keep = 1.0 - self.momentum
            new_term = rv - keep * self.running_var
            self.running_mean.copy_(rm)
            self.running_var.mul_(keep).add_(new_term, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return y

    real = FlaxBatchNorm2d._sync_forward
    FlaxBatchNorm2d._sync_forward = fused
    try:
        return step_ms()
    finally:
        FlaxBatchNorm2d._sync_forward = real


def worker_multihost(rank, world, out):
    """One rank of multihost_run_inference3d: full-width MitoNet on the
    orthoplane volume, gloo for the objects; writes its seconds, its
    stats, its K1 launches by card and (rank 0) the consensus."""
    import pickle

    import torch
    import torch.distributed as dist

    from empanada_torch.models import create_model
    from empanada_torch.ops import group
    from empanada_torch.parallel import initialize_distributed
    from empanada_torch.parallel.multihost import multihost_run_inference3d

    initialize_distributed(f"127.0.0.1:{PORT}", world, rank, backend="gloo")
    cfg = dict(MITONET)
    model = create_model(cfg.pop("arch"), seed=0, **cfg)
    vol = em_like_volume(np.random.default_rng(4), *ORTHO_SHAPE, n_blobs=30)
    kwargs = {k: v for k, v in inference_kwargs("orthoplane").items()
              if k != "device"}
    stats = {}
    dist.barrier()
    group.reset_launches()
    with PathCounter() as counter:
        t0 = time.time()
        cons = multihost_run_inference3d(model, vol, block_size=8,
                                         stats=stats, **kwargs)
        torch.cuda.synchronize()
    record = {"seconds": time.time() - t0, "stats": stats,
              "paths": counter.paths(),
              "launches_by_card": dict(group.LAUNCHES_BY_CARD),
              "instances": None if cons is None else cons[1].instances}
    with open(Path(out) / f"multihost_rank{rank}.pkl", "wb") as f:
        pickle.dump(record, f)
    dist.destroy_process_group()


def phase_multi_device(ortho_vol, dirs, tmp, profile=False):
    """(a) the mesh engine over every visible card against the run
    without a mesh, (b) K1 on every card, (c) multihost_run_inference3d
    over 2 processes on one card against one process, (d) the
    data-parallel parity step at world 2 (one card, gloo) and at world
    device_count (NCCL), (e) ``python -m empanada_torch train`` over
    every card. ``profile`` adds worker_ddp's pricing of the collectives.
    Returns K1 launches by path and card."""
    import pickle

    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.models import create_model
    from empanada_torch.ops import group
    from empanada_torch.parallel import create_mesh

    count = torch.cuda.device_count()
    print(f"multi-device phase at world {count} ({count} visible card(s))")
    cfg = dict(MITONET)
    model = create_model(cfg.pop("arch"), device="cuda", seed=0, **cfg)
    kwargs = inference_kwargs("orthoplane")
    n_slices = sum(ortho_vol.shape)

    # (a) the mesh engine: the same volume without and with the mesh,
    # each timed after an untimed run of its own (the mesh's blocks and
    # chunks are other shapes than any warm-up of the one-card path, and
    # its other cards start cold)
    mesh_kwargs = dict(kwargs, mesh=create_mesh(count))
    for label, kw in (("no mesh", kwargs), (f"mesh of {count}", mesh_kwargs)):
        t0 = time.time()
        run_inference3d(model, ortho_vol, **dict(kw, progress=False))
        torch.cuda.synchronize()
        print(f"{label}: untimed orthoplane run {time.time() - t0:.3f} s")
    plain, _, plain_s, _ = timed_orthoplane(model, ortho_vol, kwargs,
                                            "no-mesh orthoplane")
    meshed, _, mesh_s, mesh_launches = timed_orthoplane(
        model, ortho_vol, mesh_kwargs, f"mesh-{count} orthoplane")
    by_card = dict(group.LAUNCHES_BY_CARD)
    print(f"mesh of {count} card(s): {n_slices / mesh_s:.2f} slices/s "
          f"against {n_slices / plain_s:.2f} without a mesh, same call; "
          f"K1 launches per axis {mesh_launches['per_axis']}, by card "
          f"{by_card}")
    if not same_instances(plain[1].instances, meshed[1].instances):
        fail(f"mesh of {count}: the consensus differs from the run "
             f"without a mesh")
    print(f"mesh of {count}: consensus == the run without a mesh, RLE for "
          f"RLE ({len(meshed[1].instances)} instances)")

    # (b) K1 on every visible card
    for index in range(count):
        for shape in ("main", "xy"):
            rng = np.random.default_rng(40 + index)
            c, v, o = group_inputs(rng, shape, "em")
            step = GROUP_SHAPES[shape][4]
            dev = torch.device("cuda", index)
            with torch.cuda.device(index):
                got = group.group_pixels_batched(c.to(dev), v.to(dev),
                                                 o.to(dev), step)
            want = group.group_pixels_plain(c, v, o, step)
            bad = int((got.cpu() != want.cpu()).sum())
            print(f"K1 on cuda:{index} at the {shape} shape: ids on "
                  f"{got.device}, {bad} differ from the plain version")
            if bad or got.device != dev:
                fail(f"K1 on cuda:{index} ({shape}): {bad} ids differ")

    # (c) two processes on one card against one process (block 8 both)
    t0 = time.time()
    single = run_inference3d(model, ortho_vol, block_size=8,
                             **dict(kwargs, progress=False))
    torch.cuda.synchronize()
    single_s = time.time() - t0
    del model
    torch.cuda.empty_cache()
    wall, _ = run_workers("multihost", 2, tmp, local_ranks=[0, 0])
    ranks = [pickle.load(open(tmp / f"multihost_rank{r}.pkl", "rb"))
             for r in range(2)]
    for r, rec in enumerate(ranks):
        axes = {a: (s["slices"], s["dispatches"], s["d2h_bytes"])
                for a, s in rec["stats"].items()}
        print(f"multihost rank {r}: {rec['seconds']:.3f} s in the call; "
              f"per axis (slices, dispatches, d2h_bytes) {axes}; K1 "
              f"launches by card {rec['launches_by_card']}; block paths "
              f"{rec['paths']}")
        if not rec["launches_by_card"]:
            fail(f"multihost rank {r} launched no grouping kernel")
        if rec["paths"] != ["infer_blocks_resident"] * 3:
            fail(f"multihost rank {r} ran {rec['paths']}, not the "
                 f"resident path on each axis")
    print(f"multihost over 2 processes on one card: {wall:.3f} s wall "
          f"(start-up and model build included), against "
          f"{single_s:.3f} s for one process (block 8, same call)")
    if not same_instances(single[1].instances, ranks[0]["instances"]):
        fail("multihost: rank 0's consensus differs from one process's")
    print(f"multihost: rank 0's consensus == one process's, RLE for RLE "
          f"({len(single[1].instances)} instances)")

    ddp_parity(tmp, profile)
    train_command(dirs, tmp)
    return {"mesh_orthoplane": mesh_launches["total"],
            "mesh_orthoplane_by_axis": mesh_launches["per_axis"],
            "mesh_orthoplane_by_card": by_card,
            "multihost_by_rank_and_card": {
                r: rec["launches_by_card"] for r, rec in enumerate(ranks)}}


def ddp_parity(tmp, profile):
    """Phase 14 (d): one process's f32 step, then the same global batch
    at world 2 on one card (gloo) and at world device_count (NCCL), held
    to DDP_TOL; each rank's bf16 numbers (with ``profile``, the step
    beside other ways to run the collectives, see worker_ddp)."""
    import pickle

    import torch

    from empanada_torch.entry import DDP_TOL, compare_steps, step_record
    from empanada_torch.train import Trainer

    count = torch.cuda.device_count()
    batch, coords = ddp_inputs()
    trainer = Trainer(ddp_config(), device="cuda", seed=0)
    trainer.amp_dtype = None
    trainer.init_state(5)
    want = step_record(trainer, trainer.train_step(
        batch, point_coords=coords.cuda()))
    del trainer
    torch.cuda.empty_cache()
    for world, backend in ((2, "gloo"), (count, "nccl")):
        local = [0] * world if backend == "gloo" else list(range(world))
        if world == 1:
            backend = "one process, no group"
        wall, transports = run_workers("ddp", world, tmp, backend,
                                       int(profile), local_ranks=local)
        got = torch.load(tmp / "ddp_step.pt", weights_only=False)
        nums, ok = compare_steps(got, want)
        print(f"DDP world {world} ({backend}, cards {sorted(set(local))}) "
              f"vs one process, f32 step, global batch {DDP_BATCH} x "
              f"{DDP_SIDE}², TF32 off: " + ", ".join(
                  f"{k} {v:.2e} (tol {DDP_TOL[k]:.0e})"
                  for k, v in nums.items()) + f"; {wall:.1f} s wall; NCCL "
              f"transports {transports or 'none'}")
        for r in range(world):
            rec = pickle.load(open(tmp / f"ddp_rank{r}.pkl", "rb"))
            print(f"DDP world {world} rank {r} on {rec['device']}: bf16 "
                  f"{rec['images_s']:.2f} images/s (global batch "
                  f"{DDP_BATCH}), peak {rec['peak_gib']:.3f} GiB; profiled "
                  f"step {rec['step_s']:.4f} s, collectives "
                  f"{rec['collective_device_s']:.4f} s on the device "
                  f"(nccl kernels), {rec['collective_host_s']:.4f} s on the "
                  f"host (gloo / c10d calls)" + (
                      f"; all-reduce 2 KiB {rec['all_reduce_2kib_ms']:.4f} "
                      f"ms, 128 MiB {rec['all_reduce_128mib_ms']:.3f} ms; "
                      f"step {DDP_BATCH / rec['images_s'] * 1e3:.1f} ms"
                      if world > 1 else "") + (
                      f"; with torch's fused SyncBatchNorm kernels "
                      f"{rec['fused_bn_step_ms']:.1f} ms, with the batch "
                      f"norm's all-reduces on a group of their own "
                      f"{rec['bn_group_step_ms']:.1f} ms, "
                      f"with batch norm over the rank's rows "
                      f"{rec['local_bn_step_ms']:.1f} ms, the rank's "
                      f"{DDP_BATCH // world} rows alone without DDP "
                      f"{rec['alone_step_ms']:.1f} ms"
                      if "alone_step_ms" in rec else ""))
        if not ok:
            fail(f"DDP world {world} ({backend}): the step differs from "
                 f"one process's beyond the tolerances {DDP_TOL}")


def train_command(dirs, tmp):
    """Phase 14 (e): ``python -m empanada_torch train`` on the recipe
    over every visible card; one checkpoint, written by rank 0."""
    import torch
    import yaml

    count = torch.cuda.device_count()
    cfg = recipe_config(dirs, tmp, epochs=1)
    cfg["TRAIN"].update(model_dir=str(tmp / "ddp_models"), logging=False,
                        print_freq=1, run_name="ddp")
    cfg["EVAL"]["epochs_per_eval"] = 0
    path = tmp / "ddp_recipe.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    seconds, stdout = run_command(["train", str(path)],
                                  f"train over {count} card(s)")
    summaries = [line for line in stdout.splitlines()
                 if line.startswith("rank ")]
    print("\n".join(summaries))
    saved = sorted(p.name for p in (tmp / "ddp_models").iterdir())
    if stdout.count("=> saved checkpoint") != 1 or saved != [
            "ddp_checkpoint.pth", "ddp_checkpoint.pth.json"] \
            or len(summaries) != count:
        fail(f"train over {count} card(s): checkpoints {saved}, "
             f"{stdout.count('=> saved checkpoint')} saved by the ranks")


class PathCounter:
    """The script's own note of the engine's block paths while it is
    entered: each call of ``FusedStackEngine.infer_blocks`` or
    ``infer_blocks_resident`` as (path, group_pixels launches at the
    call). run_inference3d calls one per axis, after the previous axis's
    blocks were all launched, so the differences are the axes' launches.
    The package itself keeps no such count."""

    PATHS = ("infer_blocks", "infer_blocks_resident")

    def __enter__(self):
        from empanada_torch.inference.fused import FusedStackEngine
        from empanada_torch.ops import group

        self.calls = []
        self.saved = {name: getattr(FusedStackEngine, name)
                      for name in self.PATHS}
        for name, orig in self.saved.items():
            def wrapped(engine, *args, _name=name, _orig=orig, **kwargs):
                self.calls.append((_name, group.LAUNCHES["group_pixels"]))
                return _orig(engine, *args, **kwargs)
            setattr(FusedStackEngine, name, wrapped)
        return self

    def __exit__(self, *exc):
        from empanada_torch.inference.fused import FusedStackEngine

        for name, orig in self.saved.items():
            setattr(FusedStackEngine, name, orig)

    def paths(self):
        return [name for name, _ in self.calls]


def counted_orthoplane(model, vol, kwargs, label, resident):
    """run_inference3d(orthoplane, resident=) on the plain ndarray with
    the kernel counts set to 0 just before and read just after; fails
    unless every axis ran the asked-for path and launched K1. Prints
    slices/s and per axis forward seconds, seconds and K1 launches.
    Returns (result, seconds, K1 launches per axis, stats)."""
    import torch

    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.ops import group

    path = "infer_blocks_resident" if resident else "infer_blocks"
    stats = {}
    group.reset_launches()
    with PathCounter() as counter:
        t0 = time.time()
        result = run_inference3d(model, vol, stats=stats, progress=False,
                                 resident=resident, **kwargs)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    marks = [n for _, n in counter.calls] + [group.LAUNCHES["group_pixels"]]
    per_axis = {name: marks[a + 1] - marks[a] for a, name in enumerate(AXES)}
    if counter.paths() != [path] * 3 or min(per_axis.values()) <= 0:
        fail(f"{label}: paths {counter.paths()} (want {path} on every "
             f"axis), K1 launches per axis {per_axis}")
    n_slices = sum(vol.shape)
    axes = " / ".join(f"{stats['axes'][a]['forward_seconds']:.3f} "
                      f"{stats['axes'][a]['seconds']:.3f}" for a in AXES)
    print(f"{label}: {n_slices / seconds:.2f} slices/s ({seconds:.3f} s); "
          f"{path} on each axis; forward and whole seconds xy / xz / yz "
          f"{axes}; K1 launches per axis {per_axis}")
    return result, seconds, per_axis, stats


def collect_blocks(block_iter):
    """{z: (pan map, packed row)} of an engine pass, and its blocks."""
    got, blocks = {}, 0
    for z_indices, pan, packed in block_iter:
        arr = np.asarray(packed).reshape(len(z_indices), -1, 3)
        pan = np.asarray(pan)
        blocks += 1
        for j, z in enumerate(z_indices):
            if z is not None:
                got[z] = (pan[j], arr[j])
    return got, blocks, len(z_indices)


def phase_resident(vol, tmp):
    """Phase 15: (a) MitoNet at full width through run_inference3d
    (orthoplane) resident beside streaming in one call, consensus equal
    RLE for RLE; (b) each axis on the host-view route in chunks of two
    blocks against the device-tensor route, maps and runs equal slice for
    slice, with engine-alone seconds of both; (c) ``infer3d --resident``
    on a .npy crop against the streaming command, class zarr byte for
    byte; (e) ``export --stablehlo`` at (1, 512, 512, 1), the .pt2 run on
    the card against the eager forward; (f) block_cost_analysis of the
    xy block beside its engine-alone time. (d), multihost on the
    resident path, runs in phase 14. Returns K1 launches by path."""
    import torch

    from empanada_torch.cli import export as export_cli
    from empanada_torch.cli import infer3d
    from empanada_torch.data.zarr_store import open_zarr
    from empanada_torch.export import FORWARD_KW, export_model
    from empanada_torch.models import create_model
    from empanada_torch.ops import group

    cfg = dict(MITONET)
    model = create_model(cfg.pop("arch"), device="cuda", seed=0, **cfg)
    model.eval()
    kwargs = inference_kwargs("orthoplane")

    # (a) resident beside streaming (phases 5 and 14 ran these shapes)
    stream, stream_s, _, _ = counted_orthoplane(
        model, vol, kwargs, "streaming orthoplane", False)
    resident, resident_s, resident_k1, stats = counted_orthoplane(
        model, vol, kwargs, "resident orthoplane", True)
    print(f"resident one-time upload: {stats['upload_bytes']} bytes in "
          f"{stats['upload_seconds'] * 1e3:.3f} ms; resident "
          f"{sum(vol.shape) / resident_s:.2f} slices/s against streaming "
          f"{sum(vol.shape) / stream_s:.2f} in the same call")
    if not same_instances(stream[1].instances, resident[1].instances):
        fail("resident: the consensus differs from streaming's")
    print(f"resident: consensus == streaming's, RLE for RLE "
          f"({len(resident[1].instances)} instances)")

    # (b) the host-view route in chunks of two blocks, and (f)
    engine = make_engine(model)
    vol_dev = torch.from_numpy(vol).cuda()
    flops = None
    for axis, name in enumerate(AXES):
        t0 = time.time()
        want, blocks, B = collect_blocks(engine.infer_blocks_resident(
            torch.movedim(vol_dev, axis, 0)))
        tensor_s = time.time() - t0
        if flops is None:  # the xy pass: the largest block so far
            flops = engine.block_cost_analysis()["flops"]
            block_ms = tensor_s / blocks * 1e3
            xy_block = (B,) + next(iter(want.values()))[0].shape
        host = np.moveaxis(vol, axis, 0)
        t0 = time.time()
        got, _, _ = collect_blocks(engine.infer_blocks_resident(
            host, chunk_slices=2 * B))
        host_s = time.time() - t0
        chunks = -(-blocks // 2)
        bad = [z for z in want if not (
            np.array_equal(want[z][0], got[z][0])
            and np.array_equal(want[z][1], got[z][1]))]
        if sorted(got) != sorted(want) or bad:
            fail(f"resident {name}: the host-view route in chunks of "
                 f"{2 * B} slices differs from the device route at "
                 f"slices {bad[:8]}")
        print(f"resident {name}: {len(want)} slices in {blocks} blocks of "
              f"{B}; engine alone {tensor_s:.3f} s on the device tensor, "
              f"{host_s:.3f} s from the host view in {chunks} chunks of "
              f"{2 * B} slices; maps and runs equal slice for slice")

    peak = 67e12  # H100 SXM float32 (no tensor cores), NVIDIA data sheet
    print(f"xy block {xy_block}: block_cost_analysis {flops} FLOPs "
          f"(convolutions and products, torch FlopCounterMode); engine "
          f"alone {block_ms:.3f} ms a block -> "
          f"{flops / (block_ms / 1e3) / 1e12:.2f} TFLOP/s, "
          f"{flops / (block_ms / 1e3) / peak:.4f} of the 67 TFLOP/s "
          f"float32 peak (NVIDIA H100 SXM data sheet; TF32 off); card "
          f"{card_name_and_limit()}")
    block_share_bf16(model, vol_dev, xy_block, block_ms)

    # (c) the command line on a .npy crop, resident beside streaming
    tmp = Path(tmp) / "resident"
    tmp.mkdir()
    export_model(model.state_dict(), MITONET, str(tmp), "mitonet",
                 norms=NORMS)
    crop = vol[:40, :100, :150]
    outs, cli_launches = {}, None
    for tag, flags in (("stream", []), ("resident", ["--resident"])):
        path = tmp / f"{tag}.npy"
        np.save(path, crop)
        group.reset_launches()
        with PathCounter() as counter:
            t0 = time.time()
            infer3d.main([str(tmp / "mitonet.yaml"), str(path), "-mode",
                          "orthoplane", "-qlen", "3"] + flags)
            seconds = time.time() - t0
        if tag == "resident":
            cli_launches = group.LAUNCHES["group_pixels"]
        want = "infer_blocks_resident" if flags else "infer_blocks"
        if counter.paths() != [want] * 3:
            fail(f"infer3d {' '.join(flags)}: paths {counter.paths()}")
        seg = open_zarr(f"{path}_orthoplane_seg_class1.zarr")
        outs[tag] = (np.asarray(seg[:]), seg.dtype,
                     open(f"{path}_orthoplane_class1.json").read())
        print(f"infer3d {' '.join(flags) or '(streaming)'} on a "
              f"{crop.shape} .npy crop: {seconds:.3f} s, {want} on each "
              f"axis, K1 launches {group.LAUNCHES['group_pixels']}")
    if outs["stream"][1] != outs["resident"][1] \
            or outs["stream"][0].tobytes() != outs["resident"][0].tobytes() \
            or outs["stream"][2] != outs["resident"][2]:
        fail("infer3d --resident: its class zarr or json differs from the "
             "streaming command's")
    print("infer3d --resident: class zarr byte-identical to streaming's, "
          "json equal")

    # (e) the exported program
    import yaml
    from torch.export.passes import move_to_device_pass

    recipe = tmp / "mitonet_recipe.yaml"
    with open(recipe, "w") as f:
        yaml.safe_dump({"MODEL": dict(MITONET),
                        "DATASET": {"labels": [1], "thing_list": [1],
                                    "class_names": {1: "mito"},
                                    "norms": NORMS}}, f)
    torch.save({"model": {k: v.cpu() for k, v in
                          model.state_dict().items()}}, tmp / "ckpt.pth")
    t0 = time.time()
    export_cli.main([str(recipe), str(tmp / "ckpt.pth"), str(tmp / "out"),
                     "--stablehlo", "-name", "mitonet"])
    export_s = time.time() - t0
    program_path = tmp / "out" / "mitonet.pt2"
    program = move_to_device_pass(torch.export.load(str(program_path)),
                                  "cuda").module()
    x = torch.from_numpy(np.random.default_rng(15).normal(
        0, 1, (1, 1, 512, 512)).astype(np.float32)).cuda()
    with torch.no_grad():
        got = program(x)
        want = model(x, **FORWARD_KW)
    diffs = {}
    for key in ("sem_logits", "ctr_hmp", "offsets"):
        diffs[key] = float((got[key] - want[key]).abs().max())
        scale = float(want[key].abs().max())
        if got[key].device != x.device or diffs[key] > 1e-4 * scale:
            fail(f"export --stablehlo: {key} on {got[key].device} differs "
                 f"from the eager forward by {diffs[key]} (tolerance 1e-4 "
                 f"of max |value| {scale})")
    print(f"export --stablehlo of MitoNet at (1, 512, 512, 1): "
          f"{export_s:.3f} s (checkpoint read, CPU trace, save), "
          f"{program_path.stat().st_size / 2 ** 20:.1f} MiB .pt2; loaded "
          f"and moved to the card, against the eager forward (TF32 off): "
          f"max abs difference {diffs} (tolerance 1e-4 of max |value|)")
    del model
    torch.cuda.empty_cache()
    return {"resident_orthoplane": sum(resident_k1.values()),
            "resident_orthoplane_by_axis": resident_k1,
            "resident_command_line": cli_launches}


def grouped_conv_ms(model, x, reps=3):
    """(ms of the grouped 3x3 convolutions, ms of the whole forward,
    grouped calls) of one eval forward of ``model`` on ``x``, the
    fastest of ``reps``: CUDA events around the forward and around each
    convolution with 1 < groups < its input channels (RegNetY's group
    width 72)."""
    import torch

    from empanada_torch.export import FORWARD_KW

    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)
             and 1 < m.groups < m.in_channels]
    events = []

    def pre(_m, _args):
        events.append([torch.cuda.Event(enable_timing=True)])
        events[-1][0].record()

    def post(_m, _args, _out):
        events[-1].append(torch.cuda.Event(enable_timing=True))
        events[-1][1].record()

    handles = [h for m in convs for h in (
        m.register_forward_pre_hook(pre), m.register_forward_hook(post))]
    best = None
    try:
        for _ in range(reps):
            events.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.inference_mode():
                start.record()
                model(x, **FORWARD_KW)
                end.record()
            torch.cuda.synchronize()
            row = (sum(a.elapsed_time(b) for a, b in events),
                   start.elapsed_time(end), len(events))
            if best is None or row[1] < best[1]:
                best = row
    finally:
        for h in handles:
            h.remove()
    return best


def block_share_bf16(model32, vol_dev, xy_block, block_ms):
    """Phase 15 (f) in bfloat16: the same weights computing in bfloat16
    (``create_model(dtype="bfloat16")``, as the MitoNet recipe's
    ``MODEL.dtype``), the xy pass engine alone after a warm pass, its
    block's FLOPs over its time against the 989 TFLOP/s bfloat16 peak,
    beside float32's ``block_ms``; then the grouped 3x3 convolutions'
    share of one xy block forward in each dtype."""
    import torch

    from empanada_torch.models import create_model

    cfg = dict(MITONET)
    model16 = create_model(cfg.pop("arch"), device="cuda", dtype="bfloat16",
                           **cfg)
    model16.load_state_dict(model32.state_dict())
    engine = make_engine(model16)
    collect_blocks(engine.infer_blocks_resident(vol_dev))
    t0 = time.time()
    _, blocks, _ = collect_blocks(engine.infer_blocks_resident(vol_dev))
    ms16 = (time.time() - t0) / blocks * 1e3
    flops = engine.block_cost_analysis()["flops"]
    peak = 989e12  # H100 SXM bfloat16 dense, NVIDIA data sheet
    print(f"xy block {xy_block} in bfloat16: block_cost_analysis {flops} "
          f"FLOPs; engine alone {ms16:.3f} ms a block (float32 "
          f"{block_ms:.3f} ms, {block_ms / ms16:.2f}x) -> "
          f"{flops / (ms16 / 1e3) / 1e12:.2f} TFLOP/s, "
          f"{flops / (ms16 / 1e3) / peak:.4f} of the 989 TFLOP/s bfloat16 "
          f"peak (NVIDIA H100 SXM data sheet); card {card_name_and_limit()}")
    b, h, w = xy_block
    x = torch.from_numpy(np.random.default_rng(16).normal(
        0, 1, (b, 1, h, w)).astype(np.float32)).cuda()
    for label, m in (("float32", model32), ("bfloat16", model16)):
        grouped, total, calls = grouped_conv_ms(m, x)
        print(f"xy block forward {tuple(x.shape)} in {label}: grouped 3x3 "
              f"convolutions (group width 72, cuDNN) {grouped:.3f} ms in "
              f"{calls} calls of a {total:.3f} ms forward "
              f"({grouped / total:.3f})")
    del model16, engine
    torch.cuda.empty_cache()


class BlockTape:
    """While entered, each call of ``FusedStackEngine.infer_blocks`` is
    one axis: the blocks it yields are kept in ``blocks[axis]``, and each
    grouping call of its blocks in ``groups[axis]`` as (centers, valid
    mask, offsets, step, the ids of the main path's own launch), and
    the engine in ``engine``. Given
    ``replay`` (an earlier tape), infer_blocks yields that tape's blocks
    and runs nothing on the device: the host half runs again on the same
    device outputs."""

    def __init__(self, replay=None):
        self.replay = replay
        self.blocks, self.groups = [], []

    def __enter__(self):
        import torch

        from empanada_torch.inference import fused

        self.saved = (fused.FusedStackEngine.infer_blocks, fused.group_pixels)
        orig_blocks, orig_group = self.saved

        def infer_blocks(engine, *args, **kwargs):
            self.engine = engine
            axis = len(self.blocks)
            self.blocks.append([])
            self.groups.append([])
            source = (self.replay.blocks[axis] if self.replay is not None
                      else orig_blocks(engine, *args, **kwargs))
            for item in source:
                self.blocks[axis].append(item)
                yield item

        def group_pixels(centers, valid, offsets, step=1.0):
            ids = orig_group(centers, valid, offsets, step=step)
            self.groups[-1].append((centers.to(torch.int32).clone(),
                                    valid.clone(), offsets.float().clone(),
                                    float(step), ids))
            return ids

        fused.FusedStackEngine.infer_blocks = infer_blocks
        fused.group_pixels = group_pixels
        return self

    def __exit__(self, *exc):
        from empanada_torch.inference import fused

        fused.FusedStackEngine.infer_blocks, fused.group_pixels = self.saved


def bench_orthoplane(model, vol, n_gt, kwargs, label, resident=False,
                     content=True):
    """counted_orthoplane with the host core's counts set to 0 just
    before (a run with ``content`` must call it; one without may find
    nothing to call it for), then per axis instances matched a slice and
    overflow slices, and the consensus against ``n_gt`` ground-truth
    instances. Returns (result, seconds, K1 launches per axis, stats)."""
    from empanada_torch.core import native

    native.reset_calls()
    result, seconds, k1, stats = counted_orthoplane(
        model, vol, kwargs, label, resident)
    if content:
        host_path_ran(label, HOST_REQUIRED + ("kway_vote",))
    elif native.get_lib() is None:
        fail(f"the {label} path ran with the numpy host half")
    per_slice = " / ".join(
        f"{ax['instances_matched'] / ax['slices']:.2f}"
        for ax in (stats["axes"][a] for a in AXES))
    overflow = {a: stats["axes"][a]["overflow_slices"] for a in AXES}
    print(f"{label}: instances matched a slice xy / xz / yz {per_slice}; "
          f"overflow slices {overflow}; consensus "
          f"{stats['consensus_seconds']:.3f} s, {len(result[1].instances)} "
          f"3D instances against {n_gt} in the ground truth")
    return result, seconds, k1, stats


def check_tape_groups(tape, label):
    """The main path's own K1 ids on every block of every axis against
    group_pixels_plain on the same centers, valid mask and offsets;
    returns the xy block with the most valid centers (for timing)."""
    import torch

    from empanada_torch.ops import group

    busiest = None
    for a, name in enumerate(AXES):
        calls = tape.groups[a]
        valid = [int(v.sum(dim=1).max()) for _, v, _, _, _ in calls]
        for i, (c, v, o, step, ids) in enumerate(calls):
            plain = group.group_pixels_plain(c, v, o, step)
            if not torch.equal(plain, ids):
                fail(f"{label} {name} block {i}: K1's ids differ from "
                     f"group_pixels_plain's in "
                     f"{int((plain != ids).sum())} pixels")
        k = calls[0][0].shape[1]
        print(f"{label} {name}: K1 ids == group_pixels_plain on all "
              f"{len(calls)} blocks ({tuple(calls[0][2].shape[:3])} grid, "
              f"K {k}); valid centers a slice at most {max(valid)} of {k} "
              f"slots")
        if a == 0:
            busiest = calls[int(np.argmax(valid))]
    return busiest


def time_real_block(label, block):
    """K1 against its plain version and a library call on one recorded
    block with the centers of a real forward (the kernel's device time
    over the launches the profiler kept: a measurement beside the
    main path, which no lost record should end)."""
    c, v, o, step, _ = block
    row = group_timing(c, v, o, step, whole=False)
    b, h, w, _ = o.shape
    print(f"{label} K1 on a real xy block (B={b}, {h}x{w}, K="
          f"{c.shape[1]}, {int(v.sum())} valid, step {step:g}): device "
          f"{row['ms']:.5f} ms; wrapper {row['wrapper_ms']:.5f} ms, plain "
          f"{row['plain_ms']:.4f} ms, cdist+argmin {row['library_ms']:.4f} "
          f"ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}), "
          f"exhaustive scan bound {row['scan_bound_ms']:.6f} ms, kept pairs "
          f"{row['kept_pairs_ms']:.6f} ms")
    return {k: row[k] for k in ("ms", "wrapper_ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by", "scan_bound_ms")}


def bench_accuracy(label, result, gt, gt_path, tmp):
    """The port's evaluator on ``result``'s consensus against the label
    volume ``gt`` (its tracker JSON written once, at ``gt_path``); fails
    below semantic IoU 0.5, the bench heads' fit criterion. Returns the
    scores."""
    from empanada_torch.evaluation.evaluator import default_evaluator

    t0 = time.time()
    if not Path(gt_path).exists():
        gt_json(gt_path, gt)
    pred_path = Path(tmp) / f"{label.replace(' ', '_')}_pred.json"
    result[1].write_to_json(str(pred_path))
    scores = default_evaluator()(str(gt_path), str(pred_path))
    print(f"{label} accuracy against the ground truth "
          f"({time.time() - t0:.3f} s): semantic IoU {scores['iou']:.4f}, "
          f"F1@0.5 {scores['f1_50']:.4f}, PQ {scores['pq']:.4f}, F1@0.75 "
          f"{scores['f1_75']:.4f}, precision@0.5 "
          f"{scores['precision_50']:.4f}, recall@0.5 "
          f"{scores['recall_50']:.4f}")
    if not scores["iou"] >= 0.5:
        fail(f"{label}: semantic IoU {scores['iou']:.4f} < 0.5")
    return scores


def bench_taped(model, vol, n_gt, kwargs, label):
    """Warm the volume's slice shapes, then the taped streaming
    orthoplane run with every block's K1 ids held against the plain
    version. Returns (result, seconds, K1 launches per axis, stats, the
    tape, the busiest xy block)."""
    warm_axes(model, vol, kwargs, label)
    with BlockTape() as tape:
        result, seconds, k1, stats = bench_orthoplane(
            model, vol, n_gt, kwargs, label)
    busiest = check_tape_groups(tape, label)
    return result, seconds, k1, stats, tape, busiest


def bench_summary(vol, result, seconds, scores):
    return {"slices_per_sec": sum(vol.shape) / seconds,
            "instances": len(result[1].instances),
            "iou": scores["iou"], "f1_50": scores["f1_50"],
            "pq": scores["pq"]}


def phase_bench(tmp):
    """Phase 16 (float32, the parity mode): the bench MitoNet (the seeded
    full-width backbone with the committed ridge-fitted heads) on the
    bench volumes: (a) the headline orthoplane volume, streaming, with
    every block's K1 ids held against the plain version; the host half
    again with the numpy host half on the same device outputs, consensus
    equal RLE for RLE; ``resident=True``, consensus equal; (b) that
    consensus scored against its ground truth (semantic IoU >= 0.5);
    (c) the product-density slab, also scored; (d) the headline volume
    with content-free heads. Returns K1 launches by path, K1's timings
    on the busiest recorded xy block of (a) and of (c), and a summary
    for the bfloat16 run to print beside its own."""
    import torch

    from empanada_torch import bench_heads
    from empanada_torch.cli.infer3d import run_inference3d
    from empanada_torch.core import native
    from empanada_torch.data import VolumeDataset
    from empanada_torch.ops import group

    t0 = time.time()
    model = bench_heads.splice(bench_heads.bench_model(device="cuda"))
    print(f"bench MitoNet: seeded backbone with the heads of "
          f"{bench_heads.NPZ.name} (fingerprint checked) in "
          f"{time.time() - t0:.3f} s; card {card_name_and_limit()}")
    t0 = time.time()
    vol, gt = bench_heads.headline_volume()
    n_gt = int(gt.max())
    print(f"headline volume {vol.shape}, {n_gt} instances, made in "
          f"{time.time() - t0:.3f} s")
    kwargs = dict(bench_heads.HEADLINE_SETTINGS, device="cuda")

    # (a) streaming, taped; the numpy host half on the tape; resident
    result, seconds, k1, _, tape, busiest = bench_taped(
        model, vol, n_gt, kwargs, "bench headline")
    native.reset_calls()
    group.reset_launches()
    t0 = time.time()
    with BlockTape(replay=tape), native.numpy_host_half():
        plain = run_inference3d(model, vol, progress=False, **kwargs)
    plain_s = time.time() - t0
    if any(native.CALLS.values()) or group.LAUNCHES["group_pixels"]:
        fail(f"bench headline replay: host core calls {native.CALLS}, K1 "
             f"launches {group.LAUNCHES}")
    if not same_instances(result[1].instances, plain[1].instances):
        fail("bench headline: the consensus with the numpy host half "
             "differs from the C++ host core's on the same device outputs")
    print(f"bench headline: numpy host half on the same device outputs "
          f"{plain_s:.3f} s (no device work), consensus == the C++ host "
          f"core's, RLE for RLE ({len(plain[1].instances)} instances)")
    del tape
    resident, resident_s, resident_k1, _ = bench_orthoplane(
        model, vol, n_gt, kwargs, "bench headline resident", resident=True)
    if not same_instances(result[1].instances, resident[1].instances):
        fail("bench headline: resident consensus differs from streaming's")
    print(f"bench headline: resident == streaming, RLE for RLE; "
          f"{sum(vol.shape) / resident_s:.2f} against "
          f"{sum(vol.shape) / seconds:.2f} slices/s")

    # (b) accuracy against the ground truth
    scores = bench_accuracy("bench headline", result, gt,
                            Path(tmp) / "bench_gt.json", tmp)
    summary = {"headline": bench_summary(vol, result, seconds, scores)}
    timings = {"headline_xy_block": time_real_block("bench headline",
                                                    busiest)}
    del vol, gt, busiest

    # (c) the product-density slab
    t0 = time.time()
    slab, slab_gt = bench_heads.slab_volume()
    n_slab_gt = int(slab_gt.max())
    print(f"slab volume {slab.shape}, {n_slab_gt} instances, made in "
          f"{time.time() - t0:.3f} s")
    slab_kw = dict(bench_heads.SLAB_SETTINGS, device="cuda")
    slab_result, slab_s, slab_k1, slab_stats, tape, busiest = bench_taped(
        model, slab, n_slab_gt, slab_kw, "bench slab")
    # the same engine over each axis alone (no host half): beside the
    # forward seconds inside the run, what the host threads cost it
    alone = []
    for axis, name in enumerate(AXES):
        t0 = time.time()
        for _, _, packed in tape.engine.infer_blocks(
                VolumeDataset(slab, axis=axis)):
            np.asarray(packed)
        torch.cuda.synchronize()
        alone.append(f"{slab_stats['axes'][name]['forward_seconds']:.3f} / "
                     f"{time.time() - t0:.3f}")
    print(f"bench slab forward inside the run / engine alone, s, xy; xz; "
          f"yz: {'; '.join(alone)}")
    timings["slab_xy_block"] = time_real_block("bench slab", busiest)
    del tape, busiest
    scores = bench_accuracy("bench slab", slab_result, slab_gt,
                            Path(tmp) / "bench_slab_gt.json", tmp)
    summary["slab"] = bench_summary(slab, slab_result, slab_s, scores)
    del slab, slab_gt, slab_result

    # (d) the content-free ceiling on the headline volume
    vol, _ = bench_heads.headline_volume()
    model.load_state_dict(bench_heads.content_free(model.state_dict()))
    _, free_s, free_k1, _ = bench_orthoplane(
        model, vol, n_gt, kwargs, "bench headline content-free",
        content=False)
    print(f"bench headline: content-free {sum(vol.shape) / free_s:.2f} "
          f"slices/s against {sum(vol.shape) / seconds:.2f} with content")
    summary["ceiling"] = sum(vol.shape) / free_s
    del model
    torch.cuda.empty_cache()
    return {"bench_headline": sum(k1.values()),
            "bench_headline_by_axis": k1,
            "bench_headline_resident": sum(resident_k1.values()),
            "bench_slab": sum(slab_k1.values()),
            "bench_slab_by_axis": slab_k1,
            "bench_content_free": sum(free_k1.values())}, timings, summary


def phase_bench_bf16(tmp, f32):
    """Phase 16 in bfloat16 (``MODEL.dtype`` of the MitoNet recipe, as
    the JAX bench builds its model): the same bench MitoNet computing in
    bfloat16 on the headline volume and the slab, every block's K1 ids
    held against the plain version on the same tape (K1 groups float32
    centers and offsets in either dtype), each consensus scored against
    its ground truth (fails below semantic IoU 0.5), then the
    content-free ceiling; each number printed beside phase 16's float32
    one (``f32``). Returns K1 launches by path."""
    import torch

    from empanada_torch import bench_heads

    model = bench_heads.splice(bench_heads.bench_model(
        device="cuda", dtype="bfloat16"))
    print(f"bench MitoNet in bfloat16: the same weights, compute dtype "
          f"bfloat16 (batch norm float32); card {card_name_and_limit()}")
    out, launches = {}, {}
    for tag, make, settings, gt_name in (
            ("headline", bench_heads.headline_volume,
             bench_heads.HEADLINE_SETTINGS, "bench_gt.json"),
            ("slab", bench_heads.slab_volume, bench_heads.SLAB_SETTINGS,
             "bench_slab_gt.json")):
        label = f"bench {tag} bf16"
        vol, gt = make()
        result, seconds, k1, _, tape, _ = bench_taped(
            model, vol, int(gt.max()), dict(settings, device="cuda"), label)
        del tape
        scores = bench_accuracy(label, result, gt, Path(tmp) / gt_name, tmp)
        out[tag] = bench_summary(vol, result, seconds, scores)
        launches[f"bench_{tag}_bf16"] = sum(k1.values())
        launches[f"bench_{tag}_bf16_by_axis"] = k1
        del vol, gt, result
    vol, gt = bench_heads.headline_volume()
    model.load_state_dict(bench_heads.content_free(model.state_dict()))
    _, free_s, free_k1, _ = bench_orthoplane(
        model, vol, int(gt.max()), dict(bench_heads.HEADLINE_SETTINGS,
                                        device="cuda"),
        "bench headline content-free bf16", content=False)
    launches["bench_content_free_bf16"] = sum(free_k1.values())
    ceiling = sum(vol.shape) / free_s
    for tag in ("headline", "slab"):
        a, b = out[tag], f32[tag]
        print(f"bench {tag}, bfloat16 beside float32: "
              f"{a['slices_per_sec']:.2f} / {b['slices_per_sec']:.2f} "
              f"slices/s; 3D instances "
              f"{a['instances']} / {b['instances']}; semantic IoU "
              f"{a['iou']:.4f} / {b['iou']:.4f}, F1@0.5 {a['f1_50']:.4f} / "
              f"{b['f1_50']:.4f}, PQ {a['pq']:.4f} / {b['pq']:.4f}")
    print(f"bench headline content-free, bfloat16 beside float32: "
          f"{ceiling:.2f} / {f32['ceiling']:.2f} slices/s")
    del model
    torch.cuda.empty_cache()
    return launches


def phase_bench_entry():
    """Phase 17: the port's benchmark entry point, ``python -m
    empanada_torch.bench``, as a user runs it (a subprocess on this
    card): its one JSON line parsed, the JAX bench's keys (less those of
    the JAX package's circumstances) and the port's checked, the bf16
    model, every stack mode timed, the IoU gate passed. Returns the K1
    launches of its sections."""
    root = Path(__file__).resolve().parent
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "empanada_torch.bench"],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    seconds = time.time() - t0
    if proc.returncode != 0:
        fail(f"python -m empanada_torch.bench exited {proc.returncode} "
             f"after {seconds:.1f} s: {proc.stderr[-3000:]}"
             f"{proc.stdout[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"python -m empanada_torch.bench printed {len(lines)} lines, "
             f"not one: {proc.stdout[-2000:]}")
    line = json.loads(lines[0])
    print(f"python -m empanada_torch.bench: {seconds:.1f} s; its line:")
    print(lines[0])
    b = line.get("breakdown", {})
    want = {"stack_512", "per_mode_slices_per_sec", "orthoplane",
            "product_density", "flops_per_dispatch", "dispatches",
            "mfu_end_to_end_lower_bound", "card", "dtype", "iou_gate"}
    if (line.get("metric") != "mitonet_orthoplane3d_inference_throughput"
            or line.get("unit") != "slices/s"
            or not line.get("value", 0) > 0 or set(b) != want):
        fail(f"the bench's line: metric {line.get('metric')}, unit "
             f"{line.get('unit')}, value {line.get('value')}, breakdown "
             f"keys {sorted(b)} (want {sorted(want)})")
    if b["dtype"] != "bfloat16" or set(b["per_mode_slices_per_sec"]) != {
            "stream", "resident", "int8", "ceiling"} \
            or not b["mfu_end_to_end_lower_bound"] > 0 \
            or b["card"]["name"] != card_name_and_limit().split(",")[0]:
        fail(f"the bench's line: dtype {b['dtype']}, modes "
             f"{sorted(b['per_mode_slices_per_sec'])}, mfu "
             f"{b['mfu_end_to_end_lower_bound']}, card {b['card']}")
    gate = b["iou_gate"]
    if not gate["passed"] or min(gate["semantic_iou"].values()) < 0.5:
        fail(f"the bench's IoU gate: {gate}")
    print(f"bench line: {line['value']} slices/s (orthoplane, through the "
          f"zarr fill); stack {b['per_mode_slices_per_sec']}; slab "
          f"{b['product_density']['slices_per_sec']} slices/s; mfu lower "
          f"bound {b['mfu_end_to_end_lower_bound']} of 989 TFLOP/s; IoU "
          f"gate {gate['semantic_iou']} passed; card {b['card']}")
    return {f"bench_entry_{name}": b[name]["k1_launches"]
            for name in ("stack_512", "orthoplane", "product_density")}


def median_ms(fn, reps=20, warmup=3):
    """Median milliseconds of one call of fn() on the card's clock (CUDA
    events around each of ``reps`` calls, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def phase_entry():
    """Phase 18: the counterpart of the JAX package's root
    ``__graft_entry__.py``. (a) ``entry()``: ``fn(*example_args)`` and
    ``fn`` on a seeded image held bit for bit against the module's own
    forward (the flagship built again from the same seed), the forward's
    median ms (float32, TF32 off), ``torch.export`` of ``fn`` against the
    eager forward; (b) ``dryrun_multichip(device_count)`` and, where that
    is not 2, ``dryrun_multichip(2)`` (on one card: two gloo ranks share
    it and the mesh repeats it), each with the K1 counts set to 0 just
    before and read just after, and the K1 ids of every block of its
    runs held against group_pixels_plain (``BlockTape``). Returns K1
    launches by world."""
    import torch

    from empanada_torch import entry as entry_mod
    from empanada_torch.ops import group

    card = card_name_and_limit()
    t0 = time.time()
    fn, (params, image) = entry_mod.entry()
    model, _ = entry_mod._flagship()
    seeded = torch.from_numpy(np.random.default_rng(18).normal(
        0, 1, tuple(image.shape)).astype(np.float32)).to(image.device)
    print(f"entry(): MitoNet at full width, {len(params)} parameters and "
          f"buffers, image {tuple(image.shape)} on {image.device}, built in "
          f"{time.time() - t0:.1f} s")
    with torch.no_grad():
        for label, x in (("the example image (zeros)", image),
                         ("a seeded image", seeded)):
            got = fn(params, x)
            want = model(x, render_steps=2, interpolate_ins=False)
            bad = [k for k in want if not torch.equal(got[k], want[k])]
            if sorted(got) != sorted(want) or bad:
                fail(f"entry(): fn on {label} differs from the module's "
                     f"forward in {bad or sorted(got)}")
            print(f"entry(): fn(params, image) == model(image, "
                  f"render_steps=2, interpolate_ins=False) bit for bit on "
                  f"{label}: " + ", ".join(
                      f"{k} {tuple(v.shape)} max |value| "
                      f"{float(v.abs().max()):.4f}" for k, v in got.items()))
        ms = median_ms(lambda: fn(params, image))
        eager_ms = median_ms(
            lambda: model(image, render_steps=2, interpolate_ins=False))

        class Forward(torch.nn.Module):
            def forward(self, params, image):
                return fn(params, image)

        t0 = time.time()
        program = torch.export.export(Forward(), (params, image))
        export_s = time.time() - t0
        exported = program.module()(params, seeded)
        want = model(seeded, render_steps=2, interpolate_ins=False)
    print(f"entry(): forward {tuple(image.shape)} float32 (TF32 off), "
          f"median of 20 after 3 warm-ups (CUDA events): fn {ms:.3f} ms, "
          f"the module's own forward {eager_ms:.3f} ms; card {card}")
    for k in want:
        diff = float((exported[k] - want[k]).abs().max())
        scale = float(want[k].abs().max())
        print(f"entry(): torch.export of fn ({export_s:.1f} s) on the seeded "
              f"image, {k}: max abs difference {diff:.3e} from the eager "
              f"forward (max |value| {scale:.4f})")
        if not diff <= 1e-4 * scale:
            fail(f"entry(): the exported fn differs from the eager forward "
                 f"in {k} by {diff}")
    del fn, params, model, program
    torch.cuda.empty_cache()

    launches = {}
    for n in sorted({torch.cuda.device_count(), 2}):
        group.reset_launches()
        t0 = time.time()
        with BlockTape() as tape:
            report = entry_mod.dryrun_multichip(n)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        total = group.LAUNCHES["group_pixels"]
        by_card = dict(group.LAUNCHES_BY_CARD)
        blocks = 0
        for a, calls in enumerate(tape.groups):
            for i, (c, v, o, step, ids) in enumerate(calls):
                plain = group.group_pixels_plain(c, v, o, step)
                if not torch.equal(plain, ids):
                    fail(f"dryrun_multichip({n}) pass {a} block {i}: K1's "
                         f"ids differ from group_pixels_plain's in "
                         f"{int((plain != ids).sum())} pixels")
                blocks += 1
        if total == 0 or total != blocks:
            fail(f"dryrun_multichip({n}): {total} K1 launches, {blocks} "
                 f"grouping calls recorded")
        train = report["train"]
        print(f"dryrun_multichip({n}) on {card}: {seconds:.1f} s wall "
              f"(rank start-up included); ranks over "
              f"{report['backend'] or 'no group (world 1)'}, "
              f"devices {[str(d) for d in report['devices']]}; train step "
              f"loss {train['loss']:.6f}, " + ", ".join(
                  f"{k} {train[k]:.3e} (tol {entry_mod.DDP_TOL[k]:.0e})"
                  for k in entry_mod.DDP_TOL)
              + f"; mesh consensus == no mesh, RLE for RLE, "
              f"{len(report['instances'])} instance(s); K1 launches {total} "
              f"(by card {by_card}), ids == group_pixels_plain on all "
              f"{blocks} blocks of {len(tape.groups)} passes")
        launches[f"entry_dryrun_world{n}"] = total
    return launches


PORT = None


def worker(argv):
    """``--worker <kind> port rank world out [backend]``: one rank of a
    multi-process check of phase 14, on its card."""
    global PORT
    from empanada_torch.device import set_parity_numerics

    kind, PORT, rank, world, out = argv[:5]
    set_parity_numerics()
    if kind == "ddp":
        worker_ddp(int(rank), int(world), out, argv[5], argv[6] == "1")
    elif kind == "multihost":
        worker_multihost(int(rank), int(world), out)
    else:
        fail(f"unknown worker {kind}")


T_START = time.time()


def timed_phase(label, fn, *args):
    """fn(*args), printing the phase's seconds."""
    t0 = time.time()
    out = fn(*args)
    print(f"phase {label}: {time.time() - t0:.1f} s")
    return out


def main():
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        worker(sys.argv[2:])
        return
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also break the main paths' time down "
                             "(stack: engine alone, forward, postprocess, "
                             "profiler trace, host half native and numpy; "
                             "orthoplane: engine, forward and host half "
                             "alone per axis, native and numpy; consensus "
                             "at a product-like count, native and numpy; "
                             "DDP step: the collectives priced against "
                             "other ways to run them)")
    parser.add_argument("--multi-device-only", action="store_true",
                        help="run the build, the kernel checks, phase "
                             "14 (multi-device) with the volume and the "
                             "training set it needs, and phase 18 (entry)")
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
    timed_phase("2 build", phase_build)
    if args.multi_device_only:
        row = timed_phase("3 kernels", phase_group_kernel)
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            dirs = write_training_set(tmp)
            ortho_vol = em_like_volume(np.random.default_rng(4),
                                       *ORTHO_SHAPE, n_blobs=30)
            row["launches_by_path"] = timed_phase(
                "14 multi-device", phase_multi_device, ortho_vol, dirs, tmp,
                args.profile)
        row["launches_by_path"].update(timed_phase("18 entry", phase_entry))
        row["launches"] = row["launches_by_path"]["mesh_orthoplane"]
        row["launches_is"] = "the mesh orthoplane path of phase 14"
        finish(row)
        return
    trackers = density_trackers()
    timed_phase("3 host core", phase_host_core, trackers)
    row = timed_phase("3 kernels", phase_group_kernel)
    launches, model, vol = timed_phase("4 stack", phase_main_path)
    if args.profile:
        phase_breakdown(model, vol)
    ortho_launches, consensus, ortho_vol = timed_phase(
        "5 orthoplane", phase_orthoplane, model)
    if args.profile:
        phase_breakdown_orthoplane(model, ortho_vol)
        phase_consensus_at_density(trackers)
    del trackers
    with tempfile.TemporaryDirectory() as tmp:
        timed_phase("6 fill", phase_fill_store, consensus, ortho_vol.shape,
                    tmp)
        cli_launches = timed_phase("7 command line", phase_command_line,
                                   model, ortho_vol, tmp)
    del model, consensus
    # each main path's run had the counts set to 0 just before it and
    # read just after (launches_by_path); "launches" is their sum over the
    # stack and the orthoplane main paths and belongs to neither alone
    row["launches"] = launches["group_pixels"] + ortho_launches["total"]
    row["launches_is"] = "stack + orthoplane (the sum of two runs)"
    row["launches_by_path"] = {
        "stack": launches["group_pixels"],
        "orthoplane": ortho_launches["total"],
        "orthoplane_by_axis": ortho_launches["per_axis"],
        "command_line": cli_launches}
    for mode in ("stack", "orthoplane"):
        timed_phase(f"8 content ({mode})", phase_content, mode)
    # the training path: the fit (2 epochs, validation after each), a
    # validation alone, and the finetuned descriptor's stack inference,
    # each with the counts set to 0 just before it; then the
    # Panoptic-DeepLab and boundary-contour families (the BC recipe
    # trains on the training path's set); then the artifacts (on the
    # orthoplane volume) and curation (on the synthetic one)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        row["launches_by_path"]["training"], dirs = timed_phase(
            "9 training", phase_training, tmp)
        vol, gt, pdl_launches = timed_phase("10 Panoptic-DeepLab",
                                            phase_pdl, tmp)
        row["launches_by_path"].update(pdl_launches)
        timed_phase("11 boundary-contour", phase_bc, vol, gt, dirs, tmp)
        row["launches_by_path"].update(timed_phase(
            "12 artifacts", phase_artifacts, ortho_vol, tmp))
        timed_phase("13 curation", phase_curation, vol, gt, tmp)
        row["launches_by_path"].update(timed_phase(
            "14 multi-device", phase_multi_device, ortho_vol, dirs, tmp,
            args.profile))
        row["launches_by_path"].update(timed_phase(
            "15 resident and exported program", phase_resident, ortho_vol,
            tmp))
        bench_launches, bench_timings, f32_summary = timed_phase(
            "16 bench MitoNet", phase_bench, tmp)
        bench_launches.update(timed_phase(
            "16 bench MitoNet in bfloat16", phase_bench_bf16, tmp,
            f32_summary))
    row["launches_by_path"].update(bench_launches)
    for shape, timing in bench_timings.items():
        row["shapes"][shape] = {"real": timing}
    row["launches_by_path"].update(timed_phase(
        "17 bench entry point", phase_bench_entry))
    row["launches_by_path"].update(timed_phase("18 entry", phase_entry))
    finish(row)


def finish(row):
    """The run's seconds, the kernel table and the contract's last line."""
    import torch

    print(f"chip_smoke: {time.time() - T_START:.1f} s in all")
    print("kernels: group_pixels")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
