"""Slice-parallel 3D inference over a mesh of devices.

The engine-per-slice surface of the reference's multi-GPU inference
(reference scripts/inference3d_multigpu.py, patterns.forward_multigpu):
a block of ``mesh.size`` z-slices is split one slice a device, each
device runs its replica of the model, and the outputs are gathered onto
the mesh's first device. The cheap sequential tail (median window,
panoptic merge) then consumes them slice by slice in z order, with the
exact median semantics of ``PanopticDeepLabRenderEngine3d``.

For throughput prefer ``inference.fused.FusedStackEngine(mesh=...)``:
blocks of many slices a device, one packed copy to the host a block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from empanada_torch.inference.engines import (
    _instance_cells,
    _MedianQueue,
    _merge_with_cells,
)
from empanada_torch.ops.postprocess import logits_to_prob, thing_table
from empanada_torch.ops.resize import factor_pad
from empanada_torch.parallel.mesh import replicate, shard_batch

__all__ = ["SliceParallelEngine3d"]


class SliceParallelEngine3d:
    """``infer_stack(dataset)`` yields (index, (h, w) int32 pan_seg on
    the mesh's first device) in z order, the model forward batched over
    ``mesh.size`` slices. ``variables``: None, or a state_dict loaded
    into ``module`` first."""

    def __init__(self, module, variables, mesh, thing_list,
                 label_divisor=1000, stuff_area=64, void_label=0,
                 nms_threshold=0.1, nms_kernel=7, confidence_thr=0.5,
                 median_kernel_size=3, padding_factor=16,
                 coarse_boundaries=True, max_centers=256, num_classes=None):
        if variables:
            module.load_state_dict(variables)
        self.mesh = mesh
        self.replicas = [m.eval() for m in replicate(module, mesh)]
        self.device = mesh.devices[0]
        self.thing_list = list(thing_list)
        self.label_divisor = label_divisor
        self.stuff_area = stuff_area
        self.void_label = void_label
        self.nms_threshold = nms_threshold
        self.nms_kernel = nms_kernel
        self.confidence_thr = confidence_thr
        self.padding_factor = padding_factor
        self.coarse_boundaries = coarse_boundaries
        self.max_centers = max_centers
        self.queue = _MedianQueue(median_kernel_size)
        self._num_classes = num_classes
        self._table = None

    def _forward(self, images, render_steps):
        """(mesh.size, 1, H, W) host images -> dict of maps gathered on
        the first device, one slice a device."""
        outs = []
        for module, x in zip(self.replicas, shard_batch(images, self.mesh)):
            out = module(x, render_steps=render_steps,
                         interpolate_ins=not self.coarse_boundaries)
            outs.append({k: v.float() for k, v in out.items()})
        out = {k: torch.cat([o[k].to(self.device, non_blocking=True)
                             for o in outs]) for k in outs[0]}
        out["sem"] = logits_to_prob(out["sem_logits"])
        return out

    def _postprocess_one(self, out, upsampling):
        step = 4 if self.coarse_boundaries else 1
        cells = _instance_cells(
            out["ctr_hmp"], out["offsets"], nms_threshold=self.nms_threshold,
            nms_kernel=self.nms_kernel, max_centers=self.max_centers,
            step=step, scale=int(upsampling * step))
        if self._num_classes is None:
            self._num_classes = max(
                int(out["sem"].shape[1]),
                (max(self.thing_list) + 1) if self.thing_list else 1, 2)
        if self._table is None:
            self._table = thing_table(self.thing_list, self._num_classes,
                                      self.device)
        pan = _merge_with_cells(
            out["sem"], cells, self._table,
            label_divisor=self.label_divisor, stuff_area=self.stuff_area,
            void_label=self.void_label, confidence_thr=self.confidence_thr,
            max_centers=self.max_centers, num_classes=self._num_classes)
        h, w = out["size"]
        return pan[:h, :w]

    @torch.inference_mode()
    def infer_stack(self, dataset, upsampling=1):
        assert math.log2(upsampling).is_integer()
        render_steps = int(2 + math.log2(upsampling))
        b = self.mesh.size
        n = len(dataset)
        self.queue.reset()
        emitted = 0

        for block_start in range(0, n, b):
            examples = [dataset[i]
                        for i in range(block_start, min(block_start + b, n))]
            images = [np.asarray(ex["image"], np.float32)
                      for ex in examples]
            images += [np.zeros_like(images[0])] * (b - len(images))
            images, _ = factor_pad(np.stack(images), self.padding_factor)
            out = self._forward(torch.from_numpy(images)[:, None],
                                render_steps)

            for j, ex in enumerate(examples):
                slice_out = {k: v[j:j + 1] for k, v in out.items()}
                slice_out["size"] = ex["size"]
                self.queue.enqueue(slice_out)
                median_out = self.queue.get_next(keys=["sem"])
                if median_out is not None:
                    yield emitted, self._postprocess_one(median_out,
                                                         upsampling)
                    emitted += 1

        for slice_out in self.queue.remaining():
            yield emitted, self._postprocess_one(slice_out, upsampling)
            emitted += 1
