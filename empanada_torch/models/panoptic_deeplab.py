"""Panoptic-DeepLab model family (NCHW).

- ``PanopticDeepLab``: encoder (``encoder_mod``, output stride 16 or
  32) -> semantic decoder (+ an optional instance decoder whose
  low-level projections are scaled by ``ins_ratio``) -> semantic,
  center and offset heads, each upsampled 4x (bilinear,
  align_corners=True).
- ``PanopticDeepLabPR``: PointRend refinement of the semantic head.
  Eval renders ``render_steps`` 2x steps from 1/4 resolution and keeps
  the center heatmap and offsets at 1/4 resolution with
  ``interpolate_ins=False``; train mode adds ``sem_points`` and
  ``point_coords``.
- ``PanopticDeepLabBC``: boundary-contour variant: semantic and
  contour heads (``boundary_head`` on the instance features), each
  PointRend-refined (``semantic_pr``, ``boundary_pr``); no center or
  offset heads. Train mode adds ``sem_points`` / ``sem_point_coords``
  and ``cnt_points`` / ``cnt_point_coords``.

Inputs are (N, 1, H, W) float32 images; outputs are dicts of NCHW maps
with the JAX package's keys (which returns them NHWC). Children carry
the flax names, so ``weights.flax_to_torch`` maps them by path.
"""

from __future__ import annotations

from torch import nn

from empanada_torch.models.decoders.panoptic_deeplab import (
    PanopticDeepLabDecoder,
)
from empanada_torch.models.encoders import get_encoder
from empanada_torch.models.heads import PanopticDeepLabHead
from empanada_torch.models.point_rend import PointRendSemSegHead
from empanada_torch.ops.resize import interpolate_scale

__all__ = ["PanopticDeepLab", "PanopticDeepLabPR", "PanopticDeepLabBC"]


def _up(t):
    return interpolate_scale(t, 4, align_corners=True)


class PanopticDeepLab(nn.Module):
    def __init__(self, encoder="resnet50", num_classes=1, stage4_stride=16,
                 decoder_channels=256, low_level_stages=(3, 2, 1),
                 low_level_channels_project=(128, 64, 32),
                 atrous_rates=(2, 4, 6), aspp_channels=None,
                 aspp_dropout=0.1, ins_decoder=False, ins_ratio=0.5):
        super().__init__()
        assert stage4_stride in (16, 32), stage4_stride
        self.num_classes = num_classes
        self.encoder_mod = get_encoder(encoder, output_stride=stage4_stride)
        chans = self.encoder_mod.out_channels
        decoder = dict(decoder_channels=decoder_channels,
                       low_level_stages=tuple(low_level_stages),
                       atrous_rates=tuple(atrous_rates),
                       aspp_channels=aspp_channels,
                       aspp_dropout=aspp_dropout)
        self.semantic_decoder = PanopticDeepLabDecoder(
            chans, low_level_channels_project=tuple(
                low_level_channels_project), **decoder)
        if ins_decoder:
            self.instance_decoder = PanopticDeepLabDecoder(
                chans, low_level_channels_project=tuple(
                    int(s * ins_ratio) for s in low_level_channels_project),
                **decoder)
        else:
            self.instance_decoder = None
        self.sem_ch = self.semantic_decoder.out_channels
        self.ins_ch = (self.instance_decoder or self.semantic_decoder) \
            .out_channels
        self.semantic_head = PanopticDeepLabHead(self.sem_ch, num_classes)
        self._instance_heads()

    def _instance_heads(self):
        self.ins_center = PanopticDeepLabHead(self.ins_ch, 1)
        self.ins_xy = PanopticDeepLabHead(self.ins_ch, 2)

    def _encode_decode(self, x):
        pyramid = self.encoder_mod(x)
        semantic_x = self.semantic_decoder(pyramid)
        if self.instance_decoder is not None:
            instance_x = self.instance_decoder(pyramid)
        else:
            instance_x = semantic_x
        return semantic_x, instance_x

    def _apply_heads(self, semantic_x, instance_x, render_steps,
                     interpolate_ins):
        return {
            "sem_logits": _up(self.semantic_head(semantic_x)),
            "ctr_hmp": _up(self.ins_center(instance_x)),
            "offsets": _up(self.ins_xy(instance_x)),
        }

    def _train_heads(self, semantic_x, instance_x, point_coords, generator):
        return self._apply_heads(semantic_x, instance_x, 2, True)

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True,
                point_coords=None, generator=None):
        """Eval mode: ``render_steps`` and ``interpolate_ins`` as the
        engines pass them. Train mode (``model.train()``): PointRend
        points are drawn from ``generator``, or taken from
        ``point_coords``."""
        semantic_x, instance_x = self._encode_decode(x)
        if self.training:
            return self._train_heads(semantic_x, instance_x, point_coords,
                                     generator)
        return self._apply_heads(semantic_x, instance_x, render_steps,
                                 interpolate_ins)


class PanopticDeepLabPR(PanopticDeepLab):
    def __init__(self, encoder="resnet50", num_classes=1, stage4_stride=16,
                 decoder_channels=256, low_level_stages=(3, 2, 1),
                 low_level_channels_project=(128, 64, 32),
                 atrous_rates=(2, 4, 6), aspp_channels=None,
                 aspp_dropout=0.1, ins_decoder=False, ins_ratio=0.5,
                 num_fc=3, train_num_points=1024, oversample_ratio=3,
                 importance_sample_ratio=0.75, subdivision_steps=2,
                 subdivision_num_points=8192):
        super().__init__(encoder, num_classes, stage4_stride,
                         decoder_channels, low_level_stages,
                         low_level_channels_project, atrous_rates,
                         aspp_channels, aspp_dropout, ins_decoder, ins_ratio)
        self.semantic_pr = PointRendSemSegHead(
            num_classes, self.sem_ch, num_fc, subdivision_steps,
            subdivision_num_points, train_num_points, oversample_ratio,
            importance_sample_ratio)

    def _train_heads(self, semantic_x, instance_x, point_coords, generator):
        sem = self.semantic_head(semantic_x)
        pr_out = self.semantic_pr.forward_train(sem, semantic_x,
                                                point_coords, generator)
        return {
            "sem_logits": _up(pr_out["sem_seg_logits"]),
            "sem_points": pr_out["point_logits"],
            "point_coords": pr_out["point_coords"],
            "ctr_hmp": _up(self.ins_center(instance_x)),
            "offsets": _up(self.ins_xy(instance_x)),
        }

    def _apply_heads(self, semantic_x, instance_x, render_steps,
                     interpolate_ins):
        sem = self.semantic_head(semantic_x)
        ctr_hmp = self.ins_center(instance_x)
        offsets = self.ins_xy(instance_x)
        pr_out = self.semantic_pr(sem, semantic_x, render_steps=render_steps)
        return {
            "sem_logits": pr_out["sem_seg_logits"],
            "ctr_hmp": _up(ctr_hmp) if interpolate_ins else ctr_hmp,
            "offsets": _up(offsets) if interpolate_ins else offsets,
        }


class PanopticDeepLabBC(PanopticDeepLab):
    """``point_coords`` in train mode is a pair (semantic, contour) of
    (N, P, 2) coordinates, or None to draw both from ``generator``
    (semantic first)."""

    def __init__(self, encoder="resnet50", num_classes=1, stage4_stride=16,
                 decoder_channels=256, low_level_stages=(3, 2, 1),
                 low_level_channels_project=(128, 64, 32),
                 atrous_rates=(2, 4, 6), aspp_channels=None,
                 aspp_dropout=0.1, ins_decoder=False, ins_ratio=0.5,
                 num_fc=3, train_num_points=1024, oversample_ratio=3,
                 importance_sample_ratio=0.75, subdivision_steps=2,
                 subdivision_num_points=8192):
        super().__init__(encoder, num_classes, stage4_stride,
                         decoder_channels, low_level_stages,
                         low_level_channels_project, atrous_rates,
                         aspp_channels, aspp_dropout, ins_decoder, ins_ratio)
        pr = (num_fc, subdivision_steps, subdivision_num_points,
              train_num_points, oversample_ratio, importance_sample_ratio)
        self.semantic_pr = PointRendSemSegHead(num_classes, self.sem_ch,
                                               *pr)
        self.boundary_pr = PointRendSemSegHead(num_classes, self.ins_ch,
                                               *pr)

    def _instance_heads(self):
        self.boundary_head = PanopticDeepLabHead(self.ins_ch, 1)

    def _train_heads(self, semantic_x, instance_x, point_coords, generator):
        sem_coords, cnt_coords = point_coords or (None, None)
        sem = self.semantic_head(semantic_x)
        cnt = self.boundary_head(instance_x)
        sem_pr = self.semantic_pr.forward_train(sem, semantic_x, sem_coords,
                                                generator)
        cnt_pr = self.boundary_pr.forward_train(cnt, instance_x, cnt_coords,
                                                generator)
        return {
            "sem_logits": _up(sem_pr["sem_seg_logits"]),
            "sem_points": sem_pr["point_logits"],
            "sem_point_coords": sem_pr["point_coords"],
            "cnt_logits": _up(cnt_pr["sem_seg_logits"]),
            "cnt_points": cnt_pr["point_logits"],
            "cnt_point_coords": cnt_pr["point_coords"],
        }

    def _apply_heads(self, semantic_x, instance_x, render_steps,
                     interpolate_ins):
        sem = self.semantic_head(semantic_x)
        cnt = self.boundary_head(instance_x)
        return {
            "sem_logits": self.semantic_pr(
                sem, semantic_x, render_steps=render_steps)["sem_seg_logits"],
            "cnt_logits": self.boundary_pr(
                cnt, instance_x, render_steps=render_steps)["sem_seg_logits"],
        }
