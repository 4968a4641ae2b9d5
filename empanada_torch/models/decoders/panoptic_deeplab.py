"""Panoptic-DeepLab decoder (NCHW).

ASPP on the deepest pyramid level, then for each low-level stage in
the given order: a 1x1 conv-BN-ReLU projection of that level
(``project_i``), the running features resized to its size (bilinear,
align_corners=True), concatenation, and a 5x5 separable conv-BN-ReLU
fuse (``fuse_i``).
"""

from __future__ import annotations

import torch
from torch import nn

from empanada_torch.models.blocks import ConvBNAct, SeparableConvBNAct
from empanada_torch.models.decoders.aspp import ASPP
from empanada_torch.ops.resize import resize_bilinear

__all__ = ["PanopticDeepLabDecoder"]


class PanopticDeepLabDecoder(nn.Module):
    """``pyramid_channels``: the encoder's channels per pyramid level."""

    def __init__(self, pyramid_channels, decoder_channels=256,
                 low_level_stages=(3, 2, 1),
                 low_level_channels_project=(128, 64, 32),
                 atrous_rates=(2, 4, 6), aspp_channels=None,
                 aspp_dropout=0.1):
        super().__init__()
        aspp_ch = aspp_channels or decoder_channels
        self.ASPP_0 = ASPP(pyramid_channels[-1], aspp_ch, atrous_rates,
                           aspp_dropout)
        self.low_level_stages = list(low_level_stages)
        x_ch = aspp_ch
        for i, stage in enumerate(self.low_level_stages):
            proj = low_level_channels_project[i]
            self.add_module(f"project_{i}", ConvBNAct(
                pyramid_channels[stage], proj, 1))
            self.add_module(f"fuse_{i}", SeparableConvBNAct(
                x_ch + proj, decoder_channels, 5))
            x_ch = decoder_channels
        self.out_channels = x_ch

    def forward(self, pyramid_features):
        x = self.ASPP_0(pyramid_features[-1])
        for i, stage in enumerate(self.low_level_stages):
            low = getattr(self, f"project_{i}")(pyramid_features[stage])
            x = resize_bilinear(x, low.shape[-2:], align_corners=True)
            x = getattr(self, f"fuse_{i}")(torch.cat([x, low], dim=1))
        return x
