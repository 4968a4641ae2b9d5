"""2D inference engines: eval-mode model forward + panoptic postprocess.

The JAX package's ``PanopticDeepLabEngine`` and
``PanopticDeepLabRenderEngine`` on the port's postprocess
(``ops/postprocess.py``), whose pixel grouping is the CUDA kernel
``csrc/group_pixels.cu`` on the card. ``EvalModel`` is the callable
contract the engines drive, ``model(image, render_steps,
interpolate_ins) -> dict`` of NCHW float32 maps. Images are NCHW
(``(H, W)``, ``(C, H, W)`` or ``(1, C, H, W)``; batch size 1). The
z-median 3D engines and the boundary-contour engines are not ported yet.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from empanada_torch.device import resolve_device
from empanada_torch.ops.postprocess import (
    find_instance_centers,
    get_panoptic_segmentation,
    group_pixels,
    harden_semantic,
    logits_to_prob,
    merge_semantic_and_instance,
    thing_table,
)
from empanada_torch.ops.resize import factor_pad

__all__ = [
    "EvalModel",
    "PanopticDeepLabEngine",
    "PanopticDeepLabRenderEngine",
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
        centers, valid = find_instance_centers(
            ctr_hmp[:, 0], self.nms_threshold, self.nms_kernel,
            self.max_centers)
        ins = group_pixels(centers, valid, offsets.permute(0, 2, 3, 1),
                           step=float(step))
        scale = int(upsampling * step)
        if scale > 1:
            ins = ins.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        return ins

    def get_panoptic_seg(self, sem_prob, instance_cells):
        num_classes = self.num_classes(sem_prob)
        sem = harden_semantic(sem_prob, self.confidence_thr)
        table = thing_table(self.thing_list, num_classes, sem.device)
        ins = torch.where(table[sem.long()], instance_cells,
                          torch.zeros_like(instance_cells))
        return merge_semantic_and_instance(
            sem, ins, self.label_divisor, table, self.stuff_area,
            self.void_label, self.max_centers, num_classes)[0]

    def __call__(self, image, size, upsampling=1):
        assert math.log2(upsampling).is_integer(), \
            "Upsampling factor not log base 2!"
        image, _ = factor_pad(_as_nchw(image, self.device),
                              self.padding_factor)
        out = self.infer(image, int(2 + math.log2(upsampling)))
        cells = self.get_instance_cells(out["ctr_hmp"], out["offsets"],
                                        upsampling)
        h, w = size
        return self.get_panoptic_seg(out["sem"], cells)[:h, :w]


ENGINES = {
    "PanopticDeepLabEngine": PanopticDeepLabEngine,
    "PanopticDeepLabRenderEngine": PanopticDeepLabRenderEngine,
}
# the z-median 3D engines run in the port as inference/fused.py's
# FusedStackEngine behind run_inference3d; the per-slice classes and the
# boundary-contour engines come with the other model families
_NOT_PORTED = ("PanopticDeepLabEngine3d", "PanopticDeepLabRenderEngine3d",
               "BCEngine", "BCEngine3d")


def create_engine(name, model, **kwargs):
    """Registry lookup by the recipes' EVAL.engine name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet (the 3D and boundary-"
            "contour engines come with the other model families); "
            f"ported: {sorted(ENGINES)}")
    if name not in ENGINES:
        raise ValueError(f"unknown engine {name!r}; choices: {sorted(ENGINES)}")
    return ENGINES[name](model, **kwargs)
