"""Orthoplane / stack 3D inference CLI.

The canonical product flow (reference scripts/pdl_inference3d.py:20-241):
per-axis slice inference with median filtering -> forward/backward RLE
matching -> instance tracking -> cross-axis consensus -> chunked volume
fill. Exposes the reference CLI's flag surface.

The model forward + panoptic postprocess + run extraction run on the
device in blocks (inference/fused.py); RLE decoding and matching run on
host threads overlapped with the device
(inference/patterns.ForwardMatcher); the filled output is a zarr-v2
array.
"""

from __future__ import annotations

import argparse
import math
import os
import threading
import time

import numpy as np

__all__ = ["main", "run_inference3d", "print_quantized_warning"]


def _run_noexcept(fn, errors):
    """Thread target: run fn, append any exception to errors."""
    try:
        fn()
    except BaseException as e:  # re-raised on the main thread after join
        errors.append(e)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Runs empanada_torch model inference.")
    parser.add_argument("config", type=str,
                        help="Path to an exported model descriptor yaml")
    parser.add_argument("-infer-config", type=str, dest="infer_config",
                        default=None,
                        help="Inference recipe yaml (configs/median_"
                             "inference_*.yaml, BASE-inherited); its keys"
                             " become flag defaults, explicit flags win")
    parser.add_argument("volume_path", type=str,
                        help="Path to a zarr/tiff/npy volume")
    parser.add_argument("-data-key", type=str, default=None,
                        help="Array key within a zarr group")
    parser.add_argument("-mode", type=str, choices=["orthoplane", "stack"],
                        default="orthoplane")
    parser.add_argument("-qlen", type=int, default=3,
                        choices=[1, 3, 5, 7, 9, 11])
    parser.add_argument("-nmax", type=int, dest="label_divisor",
                        default=20000)
    parser.add_argument("-seg-thr", type=float, dest="seg_thr", default=0.3)
    parser.add_argument("-nms-thr", type=float, dest="nms_thr", default=0.1)
    parser.add_argument("-nms-kernel", type=int, dest="nms_kernel", default=3)
    parser.add_argument("-iou-thr", type=float, dest="iou_thr", default=0.25)
    parser.add_argument("-ioa-thr", type=float, dest="ioa_thr", default=0.25)
    parser.add_argument("-pixel-vote-thr", type=int, dest="pixel_vote_thr",
                        default=2, choices=[1, 2, 3])
    parser.add_argument("-cluster-iou-thr", type=float,
                        dest="cluster_iou_thr", default=0.75)
    parser.add_argument("-min-size", type=int, dest="min_size", default=500)
    parser.add_argument("-min-span", type=int, dest="min_span", default=4)
    parser.add_argument("-downsample-f", type=int, dest="downsample_f",
                        default=1)
    parser.add_argument("-max-centers", type=int, dest="max_centers",
                        default=256,
                        help="Static per-slice instance budget")
    parser.add_argument("-block-size", type=int, dest="block_size",
                        default=None,
                        help="Slices per fused device dispatch (default: "
                             "chosen from the slice size)")
    parser.add_argument("-n-devices", type=int, dest="n_devices", default=0,
                        help="Shard slice blocks over N devices "
                             "(0 = single device; with --use-cpu, N CPU "
                             "entries)")
    parser.add_argument("-pipeline-depth", type=int, dest="pipeline_depth",
                        default=8,
                        help="Device blocks kept in flight past the "
                             "consumer")
    parser.add_argument("--one-view", action="store_true")
    parser.add_argument("--fine-boundaries", action="store_true")
    parser.add_argument("--quantized", action="store_true",
                        help="load the executing-int8 artifact from the "
                             "descriptor (export --quantize with "
                             "calibration; models/quantization.py)")
    parser.add_argument("--resident", action="store_true",
                        help="Device-resident volume path: the volume "
                             "uploads once and every block is sliced and "
                             "padded on the device (same results as "
                             "streaming; an in-memory volume such as "
                             ".npy, full resolution, one device)")
    parser.add_argument("--use-cpu", action="store_true",
                        help="Run inference on the CPU instead of CUDA")
    parser.add_argument("--save-panoptic", action="store_true")
    parser.add_argument("-trace-dir", type=str, dest="trace_dir",
                        default=None,
                        help="Run the command under torch.profiler and "
                             "write DIR/trace.json and the host's spans "
                             "to DIR/spans.json")

    # recipe yaml (reference per-dataset configs, e.g.
    # projects/mitonet/configs/mmm_median_inference_lucchi.yaml) provides
    # flag DEFAULTS; anything the user types explicitly still wins
    import sys

    # real two-pass parse: a mini parser with ONLY -infer-config (handles
    # "=value", prefix abbreviations, missing-value errors), then the
    # recipe's keys become defaults on the main parser; explicit flags win
    scan = list(sys.argv[1:] if argv is None else argv)
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-infer-config", type=str, dest="infer_config",
                     default=None)
    pre_ns, _ = pre.parse_known_args(scan)
    if pre_ns.infer_config is not None:
        from empanada_torch.config import load_config

        recipe = load_config(pre_ns.infer_config)
        recipe.pop("BASE", None)
        dests = {a.dest for a in parser._actions}
        unknown = set(recipe) - dests
        if unknown:
            raise SystemExit(f"-infer-config: unknown keys {sorted(unknown)}")
        parser.set_defaults(**recipe)
    return parser.parse_args(argv)


def run_inference3d(
    model, volume, *, labels, thing_list, class_names=None,
    mode="orthoplane", qlen=3, label_divisor=20000, seg_thr=0.3,
    nms_thr=0.1, nms_kernel=3, iou_thr=0.25, ioa_thr=0.25,
    pixel_vote_thr=2, cluster_iou_thr=0.75, min_size=500, min_span=4,
    downsample_f=1, one_view=False, fine_boundaries=False,
    padding_factor=128, max_centers=256, save_panoptic_dir=None,
    progress=True, block_size=None, mesh=None, norms=None, tfs=None,
    resident=False, stats=None, max_runs=None, pipeline_depth=8,
    device=None,
):
    """Full 3D inference; returns {class_id: consensus InstanceTracker}.

    ``model``: an ``nn.Module`` (as ``export.load_exported_model``
    returns) or a (module, state_dict) pair (the state_dict may be
    None). ``device``: CUDA unless named; raises without a card when
    none is named. The hot path is the fused blocked engine
    (inference/fused.py): one device dispatch per ``block_size`` slices.
    ``mesh`` (``parallel.create_mesh``) shards each block's forward over
    its devices and runs the rest on its first device (``device`` is
    then ignored). ``resident``: where the volume is an in-memory
    ndarray, with device normalization, no mesh and no downsampling
    (the JAX package's gate; otherwise the run streams), the volume goes
    to the device once (``stats["upload_bytes"]``,
    ``stats["upload_seconds"]``) when it is at most ``CHUNK_BYTES``,
    each axis a ``torch.movedim`` of it, else each axis as a host view
    uploaded in chunks; the results equal streaming's.
    """
    import torch

    from empanada_torch.data import VolumeDataset
    from empanada_torch.inference import patterns
    from empanada_torch.inference.fused import CHUNK_BYTES, FusedStackEngine
    from empanada_torch.utils import profiling

    if isinstance(model, tuple):
        module, variables = model
    else:
        module, variables = model, None

    # normalize on the device so integer volumes upload in their own
    # dtype; a caller-supplied host-side ``tfs`` takes precedence
    if tfs is not None:
        device_norms = None
    else:
        device_norms = norms
        if norms is None and np.issubdtype(
                np.dtype(getattr(volume, "dtype", np.float32)), np.integer):
            raise ValueError(
                "integer-typed volume with no normalization: pass norms="
                "{'mean':..,'std':..} or a host-side tfs")

    cid = profiling.new_call()
    with profiling.span("infer.setup", cid):
        shape = tuple(volume.shape)
        axes = {"xy": 0} if mode == "stack" else {"xy": 0, "xz": 1, "yz": 2}
        trackers = patterns.create_axis_trackers(
            axes, labels, label_divisor, shape)

        # ONE engine for all axes: the weights go to the device once, and
        # everything that depends on the slice shape is derived per call
        engine = FusedStackEngine(
            module, variables, thing_list,
            block_size=block_size,
            label_divisor=label_divisor,
            median_kernel_size=qlen,
            nms_threshold=nms_thr,
            nms_kernel=nms_kernel,
            confidence_thr=seg_thr,
            padding_factor=padding_factor,
            coarse_boundaries=not fine_boundaries,
            max_centers=max_centers,
            max_runs=max_runs,
            stuff_area=0,
            device_norms=device_norms,
            pipeline_depth=pipeline_depth,
            device=device,
            mesh=mesh,
        )

        resident = (resident and mesh is None and downsample_f == 1
                    and device_norms is not None
                    and isinstance(volume, np.ndarray))
        on_device = None
        if resident and volume.nbytes <= CHUNK_BYTES:
            t0 = time.time()
            on_device = torch.from_numpy(
                np.require(volume, requirements="CW")).to(engine.device)
            if stats is not None:
                stats["upload_bytes"] = volume.nbytes
                stats["upload_seconds"] = round(time.time() - t0, 6)

    finish_threads = []
    finish_errors = []
    for axis_name, axis in axes.items():
        with profiling.span("infer.axis", cid):
            t_axis = time.time()
            with profiling.span("infer.setup"):
                matchers = patterns.create_matchers(
                    thing_list, label_divisor, iou_thr, ioa_thr)
                fm = patterns.ForwardMatcher(matchers, labels, label_divisor,
                                             thing_list)
                dataset = VolumeDataset(volume, axis=axis, tfs=tfs,
                                        scale=downsample_f)
                n = len(dataset)

                pan_stack = [] if save_panoptic_dir else None
                if pan_stack is not None:
                    sl_h, sl_w = (int(s) for s in
                                  np.asarray(dataset[0]["size"]))
            if on_device is not None:
                block_iter = engine.infer_blocks_resident(
                    torch.movedim(on_device, axis, 0))
            elif resident:
                block_iter = engine.infer_blocks_resident(
                    np.moveaxis(volume, axis, 0))
            else:
                block_iter = engine.infer_blocks(dataset,
                                                 upsampling=downsample_f)
            for z_indices, pan_block, packed in block_iter:
                fm.put_block(z_indices, pan_block, packed)
                if pan_stack is not None:
                    # blocks carry padded maps; crop to this axis's true
                    # slice shape
                    block = np.asarray(pan_block)[..., :sl_h, :sl_w]
                    pan_stack.extend(block[j] for j, z in
                                     enumerate(z_indices) if z is not None)

            # the matcher tail (queue drain, backward matching, tracking,
            # filters) is host work: run it on a thread so the NEXT axis's
            # device stream starts the moment this axis's last block is
            # dispatched. Identical to the serial composition: each axis
            # owns its matchers/trackers and consensus waits for every
            # join. The axis's span closes once the tail is handed over.
            forward_seconds = time.time() - t_axis

            def _finish(matchers=matchers,
                        axis_trackers=trackers[axis_name], n=n,
                        axis_name=axis_name, fm=fm, t_axis=t_axis,
                        forward_seconds=forward_seconds):
                rle_stack = fm.finish()
                assert len(rle_stack) == n, (len(rle_stack), n)
                patterns.finish_axis(rle_stack, matchers, axis_trackers, n,
                                     min_size, min_span, call=cid)
                if stats is not None:
                    stats.setdefault("axes", {})[axis_name] = {
                        "slices": n,
                        # axis start -> last block dispatched and handed to
                        # the matcher; "seconds" runs on to the tail's end
                        "forward_seconds": round(forward_seconds, 3),
                        "seconds": round(time.time() - t_axis, 3),
                        "overflow_slices": fm.overflow_count,
                        "instances_matched": sum(
                            len(s[c]) for s in rle_stack for c in thing_list
                            if c in s),
                    }

            th = threading.Thread(target=_run_noexcept,
                                  args=(_finish, finish_errors), daemon=True,
                                  name=f"infer-finish-{axis_name}")
            th.start()
            finish_threads.append(th)
        if progress:
            print(f"[{axis_name}] {n} slices forward in "
                  f"{forward_seconds:.1f}s")
        if pan_stack is not None:
            os.makedirs(save_panoptic_dir, exist_ok=True)
            np.save(os.path.join(save_panoptic_dir,
                                 f"panoptic_{axis_name}.npy"),
                    np.stack(pan_stack))

    with profiling.span("infer.join", cid):
        for th in finish_threads:
            th.join()
    if finish_errors:
        raise finish_errors[0]

    t_cons = time.time()
    with profiling.span("infer.consensus", cid):
        consensus = patterns.build_consensus(
            trackers, labels, thing_list, mode=mode,
            pixel_vote_thr=pixel_vote_thr, cluster_iou_thr=cluster_iou_thr,
            one_view=one_view, min_size=min_size, min_span=min_span)
    if stats is not None:
        stats["consensus_seconds"] = round(time.time() - t_cons, 3)
        stats["instances_3d"] = {
            c: len(t.instances) for c, t in consensus.items()}
    return consensus


def _mesh(args):
    """The -n-devices mesh (None for 0): the first N cards, or N CPU
    entries with --use-cpu; a -block-size that does not divide over it
    is refused here, before any work."""
    if not args.n_devices:
        return None
    import torch

    from empanada_torch.parallel import create_mesh

    mesh = create_mesh(args.n_devices, devices=(
        [torch.device("cpu")] * args.n_devices if args.use_cpu else None))
    if args.block_size is not None and args.block_size % mesh.size:
        raise SystemExit(f"-block-size {args.block_size} must divide over "
                         f"the {mesh.size}-device mesh (-n-devices)")
    print(f"slice blocks sharded over {mesh.size} devices")
    return mesh


def print_quantized_warning(desc):
    """Accuracy note for ``--quantized``: the drift against float32 that
    the export measured on its calibration data and recorded in the
    descriptor (``export._measure_int8_drift``), and the scope."""
    drift = desc.get("int8_drift")
    scope = desc.get("quantize_scope", "all")
    if drift:
        print(f"WARNING: int8 artifact (scope={scope}) measured drift "
              f"vs fp32 on its calibration data: semantic IoU "
              f"{drift['sem_iou']}, center-count delta "
              f"{drift['center_count_rel'] * 100:.1f}% "
              f"({drift['batches']} batches); use the fp32 artifact if "
              f"accuracy parity matters.")
    else:
        print("WARNING: int8 artifact has no measured drift record "
              "(exported without calibration data); int8 inference can "
              "silently lose instances vs fp32.")


def main(argv=None):
    from empanada_torch.utils.profiling import trace

    args = parse_args(argv)
    with trace(args.trace_dir, enabled=args.trace_dir is not None):
        _run_command(args)


def _run_command(args):
    assert math.log2(args.downsample_f).is_integer(), \
        "downsample factor must be a power of 2"
    mesh = _mesh(args)

    from empanada_torch.data.zarr_store import create_zarr, read_volume
    from empanada_torch.export import load_exported_model
    from empanada_torch.inference import patterns

    device = "cpu" if args.use_cpu else None
    model, desc = load_exported_model(args.config,
                                      quantized=args.quantized,
                                      device=device)
    if args.quantized:
        print_quantized_warning(desc)
    path = args.volume_path
    if args.data_key and os.path.isdir(path):
        # reference supports comma-separated keys: use the first that
        # resolves to an array in the group
        for key in args.data_key.split(","):
            candidate = os.path.join(path, key.strip())
            if os.path.exists(os.path.join(candidate, ".zarray")):
                path = candidate
                break
        else:
            path = os.path.join(path, args.data_key.split(",")[0])
    volume = read_volume(path)
    print(f"volume {volume.shape} from {args.volume_path}")

    consensus = run_inference3d(
        model, volume,
        labels=desc["labels"], thing_list=desc["thing_list"],
        class_names=desc.get("class_names"),
        mode=args.mode, qlen=args.qlen, label_divisor=args.label_divisor,
        seg_thr=args.seg_thr, nms_thr=args.nms_thr,
        nms_kernel=args.nms_kernel, iou_thr=args.iou_thr,
        ioa_thr=args.ioa_thr, pixel_vote_thr=args.pixel_vote_thr,
        cluster_iou_thr=args.cluster_iou_thr, min_size=args.min_size,
        min_span=args.min_span, downsample_f=args.downsample_f,
        one_view=args.one_view, fine_boundaries=args.fine_boundaries,
        padding_factor=desc.get("padding_factor", 128),
        max_centers=args.max_centers,
        norms=desc.get("norms"),
        block_size=args.block_size,
        pipeline_depth=args.pipeline_depth,
        mesh=mesh,
        resident=args.resident,
        save_panoptic_dir=(
            os.path.dirname(os.path.abspath(args.volume_path))
            if args.save_panoptic else None),
        device=device,
    )

    # fill each class consensus into a zarr next to the input
    base = args.volume_path.rstrip("/").rsplit(".zarr", 1)[0]
    for class_id, tracker in consensus.items():
        out_path = f"{base}_{args.mode}_seg_class{class_id}.zarr"
        out = create_zarr(out_path, tuple(volume.shape),
                          dtype=np.uint32, overwrite=True)
        patterns.fill_volume(out, tracker.instances, processes=4)
        tracker.write_to_json(f"{base}_{args.mode}_class{class_id}.json")
        print(f"class {class_id}: {len(tracker.instances)} instances "
              f"-> {out_path}")


if __name__ == "__main__":
    main()
