"""Per-slice inference engines: eval-mode model forward + panoptic
postprocess, or the boundary-contour maps.

The JAX package's six engines on the port's postprocess
(``ops/postprocess.py``), whose pixel grouping is the CUDA kernel
``csrc/group_pixels.cu`` on the card. ``EvalModel`` is the callable
contract the engines drive, ``model(image, render_steps,
interpolate_ins) -> dict`` of NCHW float32 maps. Images are NCHW
(``(H, W)``, ``(C, H, W)`` or ``(1, C, H, W)``; batch size 1).

- ``PanopticDeepLabEngine`` / ``PanopticDeepLabRenderEngine``: 2D.
- ``...Engine3d``: the same behind a z-median window over consecutive
  slices (``_MedianQueue``): ``__call__`` returns None while the window
  fills, then the middle slice with median-filtered probabilities;
  ``end()`` returns the slices still in the window, un-smoothed.
- ``BCEngine`` / ``BCEngine3d``: sigmoid semantic and contour maps
  stacked as NCHW ``(1, 2, H, W)`` (channel 0 semantic, 1 contour), the
  reference's layout; the JAX package returns them NHWC. The 3D engine
  factor-pads, medians the stacked maps and crops back.

The fused blocked engine of ``run_inference3d`` is ``inference/fused.py``.
"""

from __future__ import annotations

import contextlib
import math
from collections import deque

import numpy as np
import torch

from empanada_torch.device import resolve_device
from empanada_torch.ops.postprocess import (
    find_instance_centers,
    get_panoptic_segmentation,
    group_pixels,
    harden_semantic,
    logits_to_prob,
    median_small,
    merge_semantic_and_instance,
    thing_table,
)
from empanada_torch.ops.resize import factor_pad

__all__ = [
    "EvalModel",
    "PanopticDeepLabEngine",
    "PanopticDeepLabEngine3d",
    "PanopticDeepLabRenderEngine",
    "PanopticDeepLabRenderEngine3d",
    "BCEngine",
    "BCEngine3d",
    "ENGINES",
    "create_engine",
]


class EvalModel:
    """An ``nn.Module`` as an eval-mode callable: ``model(image,
    render_steps=2, interpolate_ins=True)`` runs the module in eval mode
    without autograd (under ``autocast_dtype`` if given, on CUDA) and
    returns its maps as float32. The module's train/eval mode is
    restored afterwards."""

    def __init__(self, module, autocast_dtype=None):
        self.module = module
        self.autocast_dtype = autocast_dtype

    def __call__(self, image, render_steps: int = 2,
                 interpolate_ins: bool = True):
        was_training = self.module.training
        self.module.eval()
        amp = torch.autocast(image.device.type, self.autocast_dtype) \
            if self.autocast_dtype is not None else contextlib.nullcontext()
        try:
            with torch.inference_mode(), amp:
                out = self.module(image, render_steps=render_steps,
                                  interpolate_ins=interpolate_ins)
        finally:
            self.module.train(was_training)
        return {k: v.float() for k, v in out.items()}


def _as_nchw(image, device):
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.asarray(image))
    if image.ndim == 2:
        image = image[None, None]
    elif image.ndim == 3:
        image = image[None]
    assert image.ndim == 4 and image.shape[0] == 1, \
        "engines are single-image (batch size 1)"
    return image.to(device=device, dtype=torch.float32)


def _padded_infer(engine, image, upsampling):
    """Factor-pad the image and infer at render_steps = 2 +
    log2(upsampling) (the render and BC 3D engines)."""
    assert math.log2(upsampling).is_integer(), \
        "Upsampling factor not log base 2!"
    image, _ = factor_pad(_as_nchw(image, engine.device),
                          engine.padding_factor)
    return engine.infer(image, int(2 + math.log2(upsampling)))


def _instance_cells(ctr_hmp, offsets, *, nms_threshold, nms_kernel,
                    max_centers, step, scale):
    """Center NMS + pixel grouping on the (coarse) grid of a (1, 1, h, w)
    heatmap and (1, 2, h, w) offsets, the ids nearest-upsampled by
    ``scale``: (1, h * scale, w * scale) int32."""
    centers, valid = find_instance_centers(
        ctr_hmp[:, 0], nms_threshold, nms_kernel, max_centers)
    ins = group_pixels(centers, valid, offsets.permute(0, 2, 3, 1),
                       step=float(step))
    if scale > 1:
        ins = ins.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
    return ins


def _merge_with_cells(sem_prob, instance_cells, table, *, label_divisor,
                      stuff_area, void_label, confidence_thr, max_centers,
                      num_classes):
    """Harden (1, C, H, W) probabilities, keep the cells on thing pixels
    and merge: (H, W) int32 panoptic ids."""
    sem = harden_semantic(sem_prob, confidence_thr)
    ins = torch.where(table[sem.long()], instance_cells,
                      torch.zeros_like(instance_cells))
    return merge_semantic_and_instance(
        sem, ins, label_divisor, table, stuff_area, void_label,
        max_centers, num_classes)[0]


class _MedianQueue:
    """Sliding median window over the model outputs of consecutive
    slices, kept on the device."""

    def __init__(self, median_kernel_size: int):
        assert median_kernel_size % 2 == 1, "Kernel size must be odd integer!"
        self.ks = median_kernel_size
        self.mid_idx = (median_kernel_size - 1) // 2
        self.median_queue = deque(maxlen=median_kernel_size)

    def reset(self):
        self.median_queue = deque(maxlen=self.ks)

    def enqueue(self, item):
        self.median_queue.append(item)

    def get_median(self, key):
        return median_small(torch.stack([out[key]
                                         for out in self.median_queue]))

    def get_next(self, keys):
        """While the queue holds at most ``mid_idx`` outputs, the newest
        one as it is; while it fills past that, None; when full, the
        middle output with ``keys`` median-filtered."""
        nq = len(self.median_queue)
        if nq <= self.mid_idx:
            return self.median_queue[-1]
        if nq < self.ks:
            return None
        output = dict(self.median_queue[self.mid_idx])
        for key in keys:
            output[key] = self.get_median(key)
        return output

    def remaining(self):
        return list(self.median_queue)[self.mid_idx + 1:]


class PanopticDeepLabEngine:
    """infer -> probabilities -> panoptic postprocess, at the model's
    full resolution. ``device``: CUDA unless named (raises without a
    card when none is named); the model must live there."""

    def __init__(self, model, thing_list, label_divisor=1000, stuff_area=64,
                 void_label=0, nms_threshold=0.1, nms_kernel=7,
                 confidence_thr=0.5, max_centers=256, num_classes=None,
                 device=None, **kwargs):
        self.device = resolve_device(device)
        self.model = model
        self.thing_list = list(thing_list)
        self.label_divisor = label_divisor
        self.stuff_area = stuff_area
        self.void_label = void_label
        self.nms_threshold = nms_threshold
        self.nms_kernel = nms_kernel
        self.confidence_thr = confidence_thr
        self.max_centers = max_centers
        self._num_classes = num_classes

    def num_classes(self, sem_prob):
        if self._num_classes is None:
            self._num_classes = max(int(sem_prob.shape[1]),
                                    (max(self.thing_list) + 1)
                                    if self.thing_list else 1, 2)
        return self._num_classes

    def infer(self, image):
        out = dict(self.model(_as_nchw(image, self.device)))
        out["sem"] = logits_to_prob(out["sem_logits"])
        return out

    def postprocess(self, sem_prob, ctr_hmp, offsets):
        """(1, C, H, W) probabilities, (1, 1, H, W) heatmap, (1, 2, H, W)
        offsets -> (H, W) int32 panoptic ids."""
        return get_panoptic_segmentation(
            sem_prob, ctr_hmp[:, 0], offsets.permute(0, 2, 3, 1),
            self.thing_list, label_divisor=self.label_divisor,
            stuff_area=self.stuff_area, void_label=self.void_label,
            threshold=self.nms_threshold, nms_kernel=self.nms_kernel,
            confidence_thr=self.confidence_thr, max_centers=self.max_centers,
            num_classes=self.num_classes(sem_prob))[0]

    def __call__(self, image):
        out = self.infer(image)
        return self.postprocess(out["sem"], out["ctr_hmp"], out["offsets"])


class PanopticDeepLabEngine3d(PanopticDeepLabEngine):
    """``PanopticDeepLabEngine`` behind the z-median window."""

    def __init__(self, *args, median_kernel_size=3, **kwargs):
        super().__init__(*args, **kwargs)
        self.queue = _MedianQueue(median_kernel_size)

    def end(self):
        return [self.postprocess(o["sem"], o["ctr_hmp"], o["offsets"])
                for o in self.queue.remaining()]

    def __call__(self, image):
        self.queue.enqueue(self.infer(image))
        median_out = self.queue.get_next(keys=["sem"])
        if median_out is None:
            return None
        return self.postprocess(median_out["sem"], median_out["ctr_hmp"],
                                median_out["offsets"])


class PanopticDeepLabRenderEngine(PanopticDeepLabEngine):
    """PointRend engine: factor-pad, infer with render_steps = 2 +
    log2(upsampling), group pixels on the coarse (1/4) grid when
    ``coarse_boundaries``, merge at full resolution."""

    def __init__(self, model, thing_list, padding_factor=16,
                 coarse_boundaries=True, **kwargs):
        super().__init__(model, thing_list, **kwargs)
        self.padding_factor = padding_factor
        self.coarse_boundaries = coarse_boundaries

    def infer(self, image, render_steps=2):
        out = dict(self.model(_as_nchw(image, self.device), render_steps,
                              interpolate_ins=not self.coarse_boundaries))
        out["sem"] = logits_to_prob(out["sem_logits"])
        return out

    def get_instance_cells(self, ctr_hmp, offsets, upsampling=1):
        """Center NMS + grouping on the (coarse) grid, the ids upsampled
        by upsampling * step: (1, H, W) int32."""
        step = 4 if self.coarse_boundaries else 1
        return _instance_cells(
            ctr_hmp, offsets, nms_threshold=self.nms_threshold,
            nms_kernel=self.nms_kernel, max_centers=self.max_centers,
            step=step, scale=int(upsampling * step))

    def get_panoptic_seg(self, sem_prob, instance_cells):
        num_classes = self.num_classes(sem_prob)
        table = thing_table(self.thing_list, num_classes, sem_prob.device)
        return _merge_with_cells(
            sem_prob, instance_cells, table,
            label_divisor=self.label_divisor, stuff_area=self.stuff_area,
            void_label=self.void_label, confidence_thr=self.confidence_thr,
            max_centers=self.max_centers, num_classes=num_classes)

    def _finalize(self, out, upsampling, size):
        cells = self.get_instance_cells(out["ctr_hmp"], out["offsets"],
                                        upsampling)
        h, w = size
        return self.get_panoptic_seg(out["sem"], cells)[:h, :w]

    def __call__(self, image, size, upsampling=1):
        return self._finalize(_padded_infer(self, image, upsampling),
                              upsampling, size)


class PanopticDeepLabRenderEngine3d(PanopticDeepLabRenderEngine):
    """``PanopticDeepLabRenderEngine`` behind the z-median window."""

    def __init__(self, *args, median_kernel_size=3, **kwargs):
        super().__init__(*args, **kwargs)
        self.queue = _MedianQueue(median_kernel_size)

    def end(self, upsampling=1):
        return [self._finalize(o, upsampling, o["size"])
                for o in self.queue.remaining()]

    def __call__(self, image, size, upsampling=1):
        out = _padded_infer(self, image, upsampling)
        out["size"] = size
        self.queue.enqueue(out)
        median_out = self.queue.get_next(keys=["sem"])
        if median_out is None:
            return None
        return self._finalize(median_out, upsampling, size)


def _bc_maps(out):
    """(1, 2, H, W): sigmoid semantic (channel 0) and contour maps."""
    assert out["sem_logits"].shape[1] == 1, "BC only works for binary"
    return torch.cat([torch.sigmoid(out["sem_logits"]),
                      torch.sigmoid(out["cnt_logits"])], dim=1)


class BCEngine:
    """Boundary-contour engine: ``__call__(image)`` -> NCHW (1, 2, H, W)
    float32 (semantic, contour) probabilities. ``device``: CUDA unless
    named."""

    def __init__(self, model, device=None, **kwargs):
        self.device = resolve_device(device)
        self.model = model

    def infer(self, image):
        return {"bc": _bc_maps(self.model(_as_nchw(image, self.device)))}

    def __call__(self, image):
        return self.infer(image)["bc"]


class BCEngine3d(BCEngine):
    """``BCEngine`` with factor padding and the z-median window over the
    stacked maps: ``__call__(image, size)`` -> (1, 2, h, w) cropped to
    ``size``, or None while the window fills; ``end()`` -> the rest."""

    def __init__(self, model, median_kernel_size=3, padding_factor=16,
                 device=None, **kwargs):
        super().__init__(model, device=device)
        self.padding_factor = padding_factor
        self.queue = _MedianQueue(median_kernel_size)

    def infer(self, image, render_steps=2):
        return {"bc": _bc_maps(self.model(image, render_steps))}

    def end(self, upsampling=1):
        return [o["bc"][..., :o["size"][0], :o["size"][1]]
                for o in self.queue.remaining()]

    def __call__(self, image, size, upsampling=1):
        out = _padded_infer(self, image, upsampling)
        out["size"] = size
        self.queue.enqueue(out)
        median_out = self.queue.get_next(keys=["bc"])
        if median_out is None:
            return None
        return median_out["bc"][..., :size[0], :size[1]]


ENGINES = {
    "PanopticDeepLabEngine": PanopticDeepLabEngine,
    "PanopticDeepLabEngine3d": PanopticDeepLabEngine3d,
    "PanopticDeepLabRenderEngine": PanopticDeepLabRenderEngine,
    "PanopticDeepLabRenderEngine3d": PanopticDeepLabRenderEngine3d,
    "BCEngine": BCEngine,
    "BCEngine3d": BCEngine3d,
}


def create_engine(name, model, **kwargs):
    """Registry lookup by the recipes' EVAL.engine name."""
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; choices: {sorted(ENGINES)}")
    return ENGINES[name](model, **kwargs)
