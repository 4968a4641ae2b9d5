#!/usr/bin/env python3
"""Build and drive the PyTorch port (empanada_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Run from the root of a checkout. Phases (each prints its results; any
failure exits non-zero before the final line):

1. device: require CUDA; print the card's name and power limit;
2. build every hand-written kernel from ``empanada_torch/csrc`` (one
   nvcc per source, all started together);
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (exact integer equality), with timings;
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

# published H100 SXM peaks (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() on the card (CUDA events)."""
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


def group_inputs(rng, b, h, w, k, n_valid):
    """Seeded inputs at the grouping kernel's main-path shapes: per slice
    ``n_valid[i]`` valid centers among k, offsets of a few pixels."""
    centers = rng.integers(0, h, (b, k, 2)).astype(np.int32)
    valid = np.zeros((b, k), bool)
    for i, nv in enumerate(n_valid):
        valid[i, rng.permutation(k)[:nv]] = True
    offsets = (rng.standard_normal((b, h, w, 2)) * 12).astype(np.float32)
    # half-pixel quantized offsets put many pixels on exact ties
    offsets[1::2] = np.round(offsets[1::2] * 2) / 2
    return centers, valid, offsets


def phase_group_kernel():
    """group_pixels kernel vs its plain version, exact, at B=8, 128^2,
    K=256; returns the kernel's JSON row (launches filled in later)."""
    import torch

    from empanada_torch.ops import group

    rng = np.random.default_rng(0)
    b, h, w, k = 8, 128, 128, 256
    mixes = {
        "mixed": [256, 256, 40, 0, 256, 17, 200, 63],
        "full": [256] * b,
        "sparse": [40] * b,
        "none": [0] * b,
    }
    worst = 0
    timed = None
    for name, n_valid in mixes.items():
        c, v, o = group_inputs(rng, b, h, w, k, n_valid)
        dev = [torch.from_numpy(a).cuda() for a in (c, v, o)]
        for step in (1.0, 4.0):
            got = group.group_pixels_batched(*dev, step)
            want = group.group_pixels_plain(*dev, step)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            if err != 0:
                n_bad = int((got != want).sum())
                fail(f"group_pixels kernel != plain ({name}, step {step}):"
                     f" {n_bad} pixels differ")
            if name == "none" and int(got.abs().max()) != 0:
                fail("group_pixels: slices without centers must be all 0")
        if name == "mixed":
            timed = (dev, n_valid)
    print(f"group_pixels: kernel == plain exactly over "
          f"{len(mixes)} center mixes x steps 1, 4 at B={b}, {h}x{w}, K={k}")

    (cen, val, off), n_valid = timed
    step = 4.0
    ms = cuda_ms(lambda: group.group_pixels_batched(cen, val, off, step))
    plain_ms = cuda_ms(lambda: group.group_pixels_plain(cen, val, off, step))

    def library():
        # yardstick only: one PyTorch call for the distances + argmin
        ys = torch.arange(h, device=off.device, dtype=torch.float32) * step
        xs = torch.arange(w, device=off.device, dtype=torch.float32) * step
        loc = torch.stack([ys[None, :, None] + off[..., 0],
                           xs[None, None, :] + off[..., 1]], dim=-1)
        d = torch.cdist(loc.reshape(b, h * w, 2), cen.float() * step)
        return d.argmin(dim=2)

    library_ms = cuda_ms(library)
    # the least work these inputs need: distances to the valid centers
    # (~7 f32 ops per pixel-center pair); each input read, output written
    flops = 7.0 * h * w * sum(n_valid)
    nbytes = cen.numel() * 4 + val.numel() + off.numel() * 4 + b * h * w * 4
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    print(f"group_pixels (B={b}, {h}x{w}, K={k}, step 4): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.cdist+argmin "
          f"{library_ms:.4f} ms, bound {max(t_ops, t_bytes):.6f} ms "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    return {
        "name": "group_pixels",
        "route": "cuda",
        "source": "empanada_torch/csrc/group_pixels.cu",
        "replaces": "empanada_tpu/ops/pallas_group.py:35",
        "launches": 0,
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
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

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

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
