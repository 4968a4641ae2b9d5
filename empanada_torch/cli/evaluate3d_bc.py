"""``python -m empanada_torch evaluate3d_bc model.yaml volume [gt.json]``:
boundary-contour 3D inference, watershed decoding and evaluation.

For each axis a ``BCEngine3d`` runs over the volume's slices; each
slice's semantic and contour probabilities are added to two uint8
stacks on the device as ``(p * (255 // n_axes))`` truncated to uint8,
so the sum over the axes stays in range; ``bc_watershed`` decodes the
two stacks (the flood on the device) into instances. ``main`` writes
``<volume>_bc_seg.zarr`` and ``pred_bc.json`` and, given a ground-truth
JSON, prints the scores. Runs on CUDA unless ``--device`` names another
device."""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

__all__ = ["main", "parse_args", "run_bc_inference3d", "seg_to_tracker"]


def run_bc_inference3d(model, volume, *, mode="orthoplane", qlen=3,
                       padding_factor=128, seg_thr=0.9, cnt_thr=0.8,
                       fg_thr=0.85, seed_thres=32, min_size=128,
                       label_divisor=1000, downsample_f=1, progress=True,
                       norms=None, device=None, stats=None):
    """Returns the dense instance labelmap (numpy) of ``volume`` from BC
    watershed decoding. ``model``: an ``nn.Module`` of the BC contract
    (``sem_logits`` and ``cnt_logits``). ``device``: CUDA unless named;
    raises without a card when none is named. ``stats`` gets per-axis
    seconds, the watershed's seconds and its flood counts."""
    from empanada_torch.data import VolumeDataset
    from empanada_torch.data.utils.transforms import create_augmentations
    from empanada_torch.device import resolve_device
    from empanada_torch.inference.engines import BCEngine3d, EvalModel
    from empanada_torch.inference.watershed import bc_watershed

    device = resolve_device(device)
    stats = stats if stats is not None else {}
    tfs = create_augmentations(None, norms=norms) if norms else None
    module = EvalModel(model.to(device).eval())

    shape = tuple(volume.shape)
    axes = {"xy": 0} if mode == "stack" else {"xy": 0, "xz": 1, "yz": 2}
    scale = 255 // len(axes)

    # accumulated uint8 probability stacks (semantic, contour)
    stacks = torch.zeros((2,) + shape, dtype=torch.uint8, device=device)

    for axis_name, axis in axes.items():
        t0 = time.time()
        engine = BCEngine3d(module, median_kernel_size=qlen,
                            padding_factor=padding_factor, device=device)
        dataset = VolumeDataset(volume, axis=axis, tfs=tfs,
                                scale=downsample_f)
        n = len(dataset)
        view = stacks.movedim(axis + 1, 1)  # (2, n, ...) view

        def put(idx, bc):
            view[:, idx] += (bc[0] * scale).to(torch.uint8)

        emitted = 0
        for i in range(n):
            ex = dataset[i]
            bc = engine(np.asarray(ex["image"], np.float32), ex["size"],
                        upsampling=downsample_f)
            if bc is not None:
                put(emitted, bc)
                emitted += 1
        for bc in engine.end(upsampling=downsample_f):
            put(emitted, bc)
            emitted += 1
        assert emitted == n
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats[f"{axis_name}_seconds"] = time.time() - t0
        if progress:
            print(f"[{axis_name}] {n} slices accumulated")

    t0 = time.time()
    flood = {}
    seg = bc_watershed(
        stacks, thres1=seg_thr, thres2=cnt_thr, thres3=fg_thr,
        seed_thres=seed_thres, min_size=min_size,
        label_divisor=label_divisor, device=device, stats=flood)
    stats["watershed_seconds"] = time.time() - t0
    stats["watershed"] = flood
    return seg


def seg_to_tracker(seg, class_id=1, label_divisor=1000):
    """Dense 3D labelmap -> finished InstanceTracker (for JSON/eval)."""
    from empanada_torch.core.rle import rle_encode
    from empanada_torch.inference.tracker import InstanceTracker

    tracker = InstanceTracker(class_id, label_divisor, seg.shape, "xy")
    flat = np.asarray(seg).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_vals = flat[order]
    bounds = np.nonzero(np.concatenate(
        [[True], sorted_vals[1:] != sorted_vals[:-1]]))[0]
    bounds = np.concatenate([bounds, [len(flat)]])
    for bi in range(len(bounds) - 1):
        label = int(sorted_vals[bounds[bi]])
        if label == 0:
            continue
        coords = np.sort(order[bounds[bi]:bounds[bi + 1]])
        starts, runs = rle_encode(coords)
        z, y, x = np.unravel_index(coords, seg.shape)
        tracker.instances[label] = {
            "box": (int(z.min()), int(y.min()), int(x.min()),
                    int(z.max()) + 1, int(y.max()) + 1, int(x.max()) + 1),
            "starts": starts,
            "runs": runs,
        }
    tracker.finished = True
    return tracker


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="BC-model 3D inference + watershed + evaluation")
    parser.add_argument("config", type=str,
                        help="Exported BC model descriptor yaml")
    parser.add_argument("volume_path", type=str)
    parser.add_argument("gt_json", type=str, nargs="?", default=None)
    parser.add_argument("-mode", type=str, default="orthoplane",
                        choices=["orthoplane", "stack"])
    parser.add_argument("-qlen", type=int, default=3)
    parser.add_argument("-seg-thr", type=float, default=0.9)
    parser.add_argument("-cnt-thr", type=float, default=0.8)
    parser.add_argument("-fg-thr", type=float, default=0.85)
    parser.add_argument("-seed-thres", type=int, default=32)
    parser.add_argument("-min-size", type=int, default=128)
    parser.add_argument("-nmax", type=int, dest="label_divisor",
                        default=1000)
    parser.add_argument("-out-dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; 'cpu' to run "
                             "on the CPU)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from empanada_torch.data.zarr_store import create_zarr, read_volume
    from empanada_torch.evaluation.evaluator import default_evaluator
    from empanada_torch.export import load_exported_model

    model, desc = load_exported_model(args.config, device=args.device)
    volume = read_volume(args.volume_path)

    seg = run_bc_inference3d(
        model, volume, mode=args.mode, qlen=args.qlen,
        padding_factor=desc.get("padding_factor", 128),
        seg_thr=args.seg_thr, cnt_thr=args.cnt_thr, fg_thr=args.fg_thr,
        seed_thres=args.seed_thres, min_size=args.min_size,
        label_divisor=args.label_divisor, norms=desc.get("norms"),
        device=args.device)

    out_dir = args.out_dir or os.path.dirname(args.volume_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    base = args.volume_path.rstrip("/").rsplit(".zarr", 1)[0]
    out = create_zarr(f"{base}_bc_seg.zarr", tuple(volume.shape),
                      dtype=np.uint32, overwrite=True)
    out[:, :, :] = seg.astype(np.uint32)

    tracker = seg_to_tracker(seg, class_id=desc["labels"][0],
                             label_divisor=args.label_divisor)
    pred_json = os.path.join(out_dir, "pred_bc.json")
    tracker.write_to_json(pred_json)
    print(f"{len(tracker.instances)} instances -> {base}_bc_seg.zarr")

    if args.gt_json:
        results = default_evaluator()(args.gt_json, pred_json)
        for name, value in results.items():
            print(f"{name}: {float(value):.4f}")
        return results


if __name__ == "__main__":
    main()
