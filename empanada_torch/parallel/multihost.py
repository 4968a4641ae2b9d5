"""Multi-process 3D inference: z-sharded ``run_inference3d``.

The reference's multi-GPU script shards slice inference over N ranks and
funnels pickled per-slice results to rank 0, which runs all matching,
tracking and consensus (reference scripts/inference3d_multigpu.py:276-379
+ empanada/inference/patterns.py forward_multigpu). Here:

- each process takes a CONTIGUOUS z-shard of every axis pass, extended
  by a median-window halo (``mid`` slices each side) so every emitted
  map is identical to the single-process run's;
- each process runs the fused blocked engine's resident path on its own
  card (its shard uploads once, blocks are sliced on the device) and
  decodes its slices' runs to RLEs, so only O(#runs) bytes leave a
  device;
- rank 0 gathers the ordered shards (``collectives.all_gather_objects``,
  over gloo), then runs the single-process matching -> backward matching
  -> tracking -> consensus flow of ``cli.infer3d.run_inference3d``.

Bring-up: ``parallel.initialize_distributed`` (or any
``torch.distributed.init_process_group``) in every process first.
"""

from __future__ import annotations

import numpy as np

__all__ = ["z_shard", "local_rle_shard", "multihost_run_inference3d"]


def z_shard(n, rank, world):
    """Contiguous near-even split of n slices: rank -> [start, end)."""
    per = -(-n // world)
    start = min(rank * per, n)
    return start, min(start + per, n)


def local_rle_shard(engine, vol_view, start, end, *, labels, label_divisor,
                    thing_list, upsampling=1, stats=None):
    """Run the fused engine's resident path over this process's extended
    z-shard ``vol_view[lo:hi]`` and return [(global_z, unmatched
    rle_seg)] for global z in [start, end).

    The shard is extended by ``mid`` halo slices each side so the median
    window sees the same neighbours as the single-process pass.
    ``stats`` (optional dict) receives this rank's device accounting:
    ``dispatches`` (blocks run) and ``d2h_bytes`` (packed run buffers +
    dense overflow pulls), both of which should scale ~1/world.
    """
    from empanada_torch.inference.rle import (
        pan_seg_to_rle_seg,
        runs_to_rle_seg,
        unpack_packed_runs,
    )

    n = len(vol_view)
    mid = engine.mid
    lo = max(0, start - mid)
    hi = min(n, end + mid)
    dispatches = 0
    d2h_bytes = 0
    out = []
    for z_indices, pan_block, packed in engine.infer_blocks_resident(
            vol_view[lo:hi], upsampling=upsampling):
        arr = np.asarray(packed).reshape(len(z_indices), -1, 3)
        dispatches += 1
        d2h_bytes += arr.nbytes
        pad_shape = tuple(pan_block.shape[-2:])
        for j, zl in enumerate(z_indices):
            if zl is None:
                continue
            z = lo + zl
            if not (start <= z < end):
                continue  # halo emission owned by a neighbour rank
            starts, ends, values, (oh, ow) = unpack_packed_runs(
                arr[j], pad_shape)
            if starts is not None:
                rle_seg = runs_to_rle_seg(
                    starts, ends, values, (oh, ow), labels, label_divisor,
                    thing_list)
            else:  # run budget overflow: pull this slice's dense map
                pan = pan_block[j]
                d2h_bytes += pan.nbytes
                rle_seg = pan_seg_to_rle_seg(pan[:oh, :ow], labels,
                                             label_divisor, thing_list)
            out.append((z, rle_seg))
    if stats is not None:
        stats["dispatches"] = dispatches
        stats["d2h_bytes"] = d2h_bytes
    return out


def multihost_run_inference3d(
        model, volume, *, labels, thing_list, class_names=None,
        mode="orthoplane", qlen=3, label_divisor=20000, seg_thr=0.3,
        nms_thr=0.1, nms_kernel=3, iou_thr=0.25, ioa_thr=0.25,
        pixel_vote_thr=2, cluster_iou_thr=0.75, min_size=500, min_span=4,
        one_view=False, fine_boundaries=False, padding_factor=128,
        max_centers=256, block_size=8, norms=None, progress=False,
        device=None, stats=None):
    """Z-sharded multi-process ``run_inference3d``: every process calls
    this with the same model and volume; rank 0 returns {class_id:
    consensus InstanceTracker}, the other ranks None. At world size 1 it
    is the local flow. ``model``: an ``nn.Module`` or a (module,
    state_dict) pair. ``block_size`` is passed to each rank's engine as
    it is: the automatic block would clamp to a short shard's length, and
    another batch can change the convolution algorithm the library picks.
    ``device``: this process's card unless named. ``stats`` (optional
    dict) gets this rank's {axis: {"dispatches", "d2h_bytes", "slices"}}.
    """
    from empanada_torch.inference import patterns
    from empanada_torch.inference.fused import FusedStackEngine
    from empanada_torch.parallel.collectives import all_gather_objects
    from empanada_torch.parallel.mesh import world

    module, variables = model if isinstance(model, tuple) else (model, None)
    size, rank = world()

    shape = tuple(volume.shape)
    axes = {"xy": 0} if mode == "stack" else {"xy": 0, "xz": 1, "yz": 2}
    trackers = patterns.create_axis_trackers(axes, labels, label_divisor,
                                             shape)
    volume = np.asarray(volume)
    engine = FusedStackEngine(
        module, variables, thing_list, block_size=block_size,
        label_divisor=label_divisor, median_kernel_size=qlen,
        nms_threshold=nms_thr, nms_kernel=nms_kernel,
        confidence_thr=seg_thr, padding_factor=padding_factor,
        coarse_boundaries=not fine_boundaries, max_centers=max_centers,
        stuff_area=0, device_norms=norms, device=device)

    for axis_name, axis in axes.items():
        view = volume if axis == 0 else np.moveaxis(volume, axis, 0)
        n = len(view)
        start, end = z_shard(n, rank, size)
        axis_stats = {}
        local = local_rle_shard(
            engine, view, start, end, labels=labels,
            label_divisor=label_divisor, thing_list=thing_list,
            stats=axis_stats)
        if stats is not None:
            stats[axis_name] = dict(axis_stats, slices=end - start)
        gathered = all_gather_objects(local)
        if rank != 0:
            continue

        by_z = {z: seg for part in gathered for z, seg in part}
        assert sorted(by_z) == list(range(n)), "shard coverage hole"

        matchers = patterns.create_matchers(thing_list, label_divisor,
                                            iou_thr, ioa_thr)
        rle_stack = [patterns.apply_matchers(by_z[z], matchers)
                     for z in range(n)]
        patterns.finish_axis(rle_stack, matchers, trackers[axis_name], n,
                             min_size, min_span)
        if progress:
            print(f"[{axis_name}] {n} slices over {size} processes")

    if rank != 0:
        return None
    return patterns.build_consensus(
        trackers, labels, thing_list, mode=mode,
        pixel_vote_thr=pixel_vote_thr, cluster_iou_thr=cluster_iou_thr,
        one_view=one_view, min_size=min_size, min_span=min_span)
