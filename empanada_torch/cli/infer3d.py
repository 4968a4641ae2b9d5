"""Stack-mode 3D inference (``run_inference3d``).

Per-axis slice inference with median filtering -> forward/backward RLE
matching -> instance tracking -> (stack mode) the single axis as the
result. The model forward + panoptic postprocess + run extraction run
on the device in blocks (inference/fused.py); the matching runs on host
threads overlapped with the device. Orthoplane consensus and the
command-line ``main`` (which needs the export loader) are later slices
of the port.
"""

from __future__ import annotations

import threading
import time

import numpy as np

__all__ = ["run_inference3d"]


def _run_noexcept(fn, errors):
    """Thread target: run fn, append any exception to errors."""
    try:
        fn()
    except BaseException as e:  # re-raised on the main thread after join
        errors.append(e)


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
    """3D inference; returns {class_id: InstanceTracker}.

    ``model``: an ``nn.Module`` or a (module, state_dict) pair (the
    state_dict may be None). ``device``: CUDA unless named; raises
    without a card when none is named. ``mode="stack"`` only:
    orthoplane, ``mesh`` and ``resident`` raise NotImplementedError.
    """
    import os

    from empanada_torch.data import VolumeDataset
    from empanada_torch.inference import patterns
    from empanada_torch.inference.fused import FusedStackEngine

    if mode != "stack":
        raise NotImplementedError(
            "orthoplane mode is the next slice of the port (cross-axis "
            "consensus, inference/consensus.py + core/fill.py); use "
            "mode='stack'")
    if mesh is not None or resident:
        raise NotImplementedError(
            "the mesh and device-resident paths are not ported")

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

    shape = tuple(volume.shape)
    axes = {"xy": 0}
    trackers = patterns.create_axis_trackers(
        axes, labels, label_divisor, shape)

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
    )

    finish_threads = []
    finish_errors = []
    for axis_name, axis in axes.items():
        t_axis = time.time()
        matchers = patterns.create_matchers(
            thing_list, label_divisor, iou_thr, ioa_thr)
        fm = patterns.ForwardMatcher(matchers, labels, label_divisor,
                                     thing_list)
        dataset = VolumeDataset(volume, axis=axis, tfs=tfs,
                                scale=downsample_f)
        n = len(dataset)

        pan_stack = [] if save_panoptic_dir else None
        if pan_stack is not None:
            sl_h, sl_w = (int(s) for s in np.asarray(dataset[0]["size"]))
        for z_indices, pan_block, packed in engine.infer_blocks(
                dataset, upsampling=downsample_f):
            fm.put_block(z_indices, pan_block, packed)
            if pan_stack is not None:
                block = np.asarray(pan_block)[..., :sl_h, :sl_w]
                pan_stack.extend(block[j] for j, z in enumerate(z_indices)
                                 if z is not None)

        # the matcher tail (queue drain, backward matching, tracking,
        # filters) is host work: run it on a thread so a next axis's
        # device stream could start at once; consensus waits for joins
        def _finish(matchers=matchers,
                    axis_trackers=trackers[axis_name], n=n,
                    axis_name=axis_name, fm=fm, t_axis=t_axis):
            rle_stack = fm.finish()
            assert len(rle_stack) == n, (len(rle_stack), n)
            patterns.finish_axis(rle_stack, matchers, axis_trackers, n,
                                 min_size, min_span)
            if stats is not None:
                stats.setdefault("axes", {})[axis_name] = {
                    "slices": n,
                    "seconds": round(time.time() - t_axis, 3),
                    "overflow_slices": fm.overflow_count,
                    "instances_matched": sum(
                        len(s[c]) for s in rle_stack for c in thing_list
                        if c in s),
                }

        th = threading.Thread(target=_run_noexcept,
                              args=(_finish, finish_errors), daemon=True)
        th.start()
        finish_threads.append(th)
        if progress:
            print(f"[{axis_name}] {n} slices forward in "
                  f"{time.time() - t_axis:.1f}s")
        if pan_stack is not None:
            os.makedirs(save_panoptic_dir, exist_ok=True)
            np.save(os.path.join(save_panoptic_dir,
                                 f"panoptic_{axis_name}.npy"),
                    np.stack(pan_stack))

    for th in finish_threads:
        th.join()
    if finish_errors:
        raise finish_errors[0]

    t_cons = time.time()
    consensus = patterns.build_consensus(
        trackers, labels, thing_list, mode=mode,
        pixel_vote_thr=pixel_vote_thr, cluster_iou_thr=cluster_iou_thr,
        one_view=one_view, min_size=min_size, min_span=min_span)
    if stats is not None:
        stats["consensus_seconds"] = round(time.time() - t_cons, 3)
        stats["instances_3d"] = {
            c: len(t.instances) for c, t in consensus.items()}
    return consensus
