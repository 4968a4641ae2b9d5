"""Panoptic-BiFPN model family (NCHW). MitoNet is ``PanopticBiFPNPR`` on
regnety_6p4gf.

Pipeline: encoder 5-level pyramid -> P2 resampled to fpn_dim; BiFPN over
[P3, P4, P5] (adds P6/P7); BiFPNDecoder ladders [P7..P3, P2] back to 1/4
resolution; Panoptic-DeepLab heads (+ PointRend on the semantic head).
"""

from __future__ import annotations

from torch import nn

from empanada_torch.models.blocks import Resample2d
from empanada_torch.models.decoders.bifpn import BiFPN, BiFPNDecoder
from empanada_torch.models.encoders import get_encoder
from empanada_torch.models.heads import PanopticDeepLabHead
from empanada_torch.models.point_rend import PointRendSemSegHead
from empanada_torch.ops.resize import interpolate_scale

__all__ = ["PanopticBiFPN", "PanopticBiFPNPR"]


def _up(t):
    return interpolate_scale(t, 4, align_corners=True)


class PanopticBiFPN(nn.Module):
    """Takes (N, 1, H, W) float32 images and returns a dict of NCHW maps:
    ``sem_logits`` (N, C, H, W), ``ctr_hmp`` (N, 1, H, W) and
    ``offsets`` (N, 2, H, W) with channels (dy, dx). The JAX package
    returns the same maps NHWC. Train mode (``model.train()``) gives the
    same keys at the same resolution; batch norm then uses and updates
    batch statistics."""

    def __init__(self, encoder="regnety_6p4gf", num_classes=1, fpn_dim=160,
                 fpn_layers=3, ins_decoder=False, depthwise=True):
        super().__init__()
        self.num_classes = num_classes
        self.encoder_mod = get_encoder(encoder)
        chans = self.encoder_mod.out_channels
        self.p2_resample = Resample2d(chans[1], fpn_dim)
        self.semantic_fpn = BiFPN(chans[2:], fpn_dim, fpn_layers, depthwise)
        self.semantic_decoder = BiFPNDecoder(fpn_dim)
        if ins_decoder:
            self.instance_fpn = BiFPN(chans[2:], fpn_dim, fpn_layers,
                                      depthwise)
            self.instance_decoder = BiFPNDecoder(fpn_dim)
        else:
            self.instance_fpn = None
        self.semantic_head = PanopticDeepLabHead(fpn_dim, num_classes)
        self.ins_center = PanopticDeepLabHead(fpn_dim, 1)
        self.ins_xy = PanopticDeepLabHead(fpn_dim, 2)

    def _encode_decode(self, x):
        pyramid = self.encoder_mod(x)
        p2 = self.p2_resample(pyramid[1])
        semantic_pyr = [p2] + self.semantic_fpn(pyramid[2:])
        semantic_x = self.semantic_decoder(semantic_pyr[::-1])
        if self.instance_fpn is not None:
            instance_pyr = [p2] + self.instance_fpn(pyramid[2:])
            instance_x = self.instance_decoder(instance_pyr[::-1])
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

    def forward(self, x, render_steps: int = 2, interpolate_ins: bool = True,
                point_coords=None, generator=None):
        semantic_x, instance_x = self._encode_decode(x)
        if self.training:
            return self._train_heads(semantic_x, instance_x, point_coords,
                                     generator)
        return self._apply_heads(semantic_x, instance_x, render_steps,
                                 interpolate_ins)

    def _train_heads(self, semantic_x, instance_x, point_coords, generator):
        return self._apply_heads(semantic_x, instance_x, 2, True)


class PanopticBiFPNPR(PanopticBiFPN):
    """PanopticBiFPN with PointRend rendering of the semantic logits:
    ``render_steps`` 2x steps from 1/4 resolution (2 = full resolution).
    With ``interpolate_ins=False`` the center heatmap and offsets stay at
    1/4 resolution (the engine's coarse-boundaries contract).

    Train mode adds ``sem_points`` (N, P, C) and ``point_coords``
    (N, P, 2), the PointRend predictions at importance-sampled points
    drawn from ``generator`` (or at the given ``point_coords``), and
    returns ``sem_logits`` as the coarse logits upsampled 4x
    (align_corners=True)."""

    def __init__(self, encoder="regnety_6p4gf", num_classes=1, fpn_dim=160,
                 fpn_layers=3, ins_decoder=False, depthwise=True, num_fc=3,
                 subdivision_steps=2, subdivision_num_points=8192,
                 train_num_points=1024, oversample_ratio=3,
                 importance_sample_ratio=0.75):
        super().__init__(encoder, num_classes, fpn_dim, fpn_layers,
                         ins_decoder, depthwise)
        self.semantic_pr = PointRendSemSegHead(
            num_classes, fpn_dim, num_fc, subdivision_steps,
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
