"""BiFPN feature pyramid + ladder decoder (NCHW).

- P6/P7 are built from P5 via a 1x1 resample + maxpool downsize;
- each BiFPNLayer runs a top-down then a bottom-up pass with fast-fusion
  (relu-normalized) scalar weights and ONE shared after-combine conv
  per pass;
- BiFPNDecoder ladders transposed-conv 2x upsamples with skip concats
  from P6..P2 and finishes with a 5x5 separable conv.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from empanada_torch.models.blocks import (
    ConvBNAct,
    ConvTransposeBNAct,
    Resample2d,
    Resize2d,
    SeparableConvBNAct,
    promote,
)

__all__ = ["BiFPN", "BiFPNDecoder"]

EPS = 1e-4


def _fusion_weights(param, eps=EPS):
    w = F.relu(param)
    return w / (torch.sum(w) + eps)


def _after(fpn_dim, depthwise):
    if depthwise:
        return SeparableConvBNAct(fpn_dim, fpn_dim, 3, act=F.silu)
    return ConvBNAct(fpn_dim, fpn_dim, 3)


class TopDownFPN(nn.Module):
    """Input: features smallest-resolution first. Fuses downward.

    ``in_channels`` lists the channels of feats[1..n_levels]. The fusion
    runs in float32 in a bfloat16 model (flax's promotion by the float32
    weights)."""

    compute_dtype = torch.float32

    def __init__(self, fpn_dim, in_channels, depthwise=True):
        super().__init__()
        self.n_levels = len(in_channels)
        self.fusion_weights = nn.Parameter(torch.ones(self.n_levels + 1))
        self.resize_up = Resize2d(2, "up")
        self.after = _after(fpn_dim, depthwise)
        for i, c in enumerate(in_channels):
            self.add_module(f"resample_{i}", Resample2d(c, fpn_dim))

    def forward(self, feats: List[torch.Tensor]):
        dt = self.compute_dtype
        weights = _fusion_weights(self.fusion_weights)
        out = [feats[0]]
        for i in range(self.n_levels):
            high = promote(getattr(self, f"resample_{i}")(feats[i + 1]), dt)
            w1, w2 = weights[i], weights[i + 1]
            fused = (w1 * promote(self.resize_up(out[-1]), dt) + w2 * high) \
                / (w1 + w2 + EPS)
            out.append(self.after(fused))
        return out


class BottomUpFPN(nn.Module):
    """Input: pyramid largest-res first (levels 1..n) plus top-down outputs.

    ``in_channels`` lists the channels of pyramid[0..n_levels-1]. The
    fusion runs in float32 in a bfloat16 model, as in ``TopDownFPN``."""

    compute_dtype = torch.float32

    def __init__(self, fpn_dim, in_channels, depthwise=True):
        super().__init__()
        self.n_levels = len(in_channels)
        self.fusion_weights = nn.Parameter(torch.ones(self.n_levels + 1))
        self.resize_down = Resize2d(2, "down")
        self.after = _after(fpn_dim, depthwise)
        for i, c in enumerate(in_channels):
            self.add_module(f"resample_{i}", Resample2d(c, fpn_dim))

    def forward(self, pyramid, top_down):
        dt = self.compute_dtype
        weights = _fusion_weights(self.fusion_weights)
        out = [top_down[0]]
        for i in range(self.n_levels):
            pyr = promote(getattr(self, f"resample_{i}")(pyramid[i]), dt)
            down = promote(self.resize_down(out[-1]), dt)
            if i < self.n_levels - 1:
                w1, w2, w3 = weights[i], weights[i + 1], weights[i + 2]
                num = (w1 * down + w2 * pyr
                       + w3 * promote(top_down[i + 1], dt))
                den = w1 + w2 + w3 + EPS
            else:
                w1, w2 = weights[i], weights[i + 1]
                num = w1 * down + w2 * pyr
                den = w1 + w2 + EPS
            out.append(self.after(num / den))
        return out


class BiFPNLayer(nn.Module):
    """``in_channels``: channels of the pyramid levels, largest first."""

    def __init__(self, fpn_dim, in_channels, depthwise=True):
        super().__init__()
        rev = list(in_channels)[::-1]
        self.top_down = TopDownFPN(fpn_dim, rev[1:], depthwise)
        self.bottom_up = BottomUpFPN(fpn_dim, list(in_channels)[1:],
                                     depthwise)

    def forward(self, pyramid):
        td = self.top_down(pyramid[::-1])
        return self.bottom_up(pyramid[1:], td[::-1])


class BiFPN(nn.Module):
    """Takes [P3, P4, P5]; adds P6, P7; returns 5 fused levels largest
    first."""

    def __init__(self, in_channels, fpn_dim=160, num_layers=3,
                 depthwise=True):
        super().__init__()
        self.p6_resample = Resample2d(in_channels[-1], fpn_dim)
        self.downsize = Resize2d(2, "down")
        chans = list(in_channels) + [fpn_dim, fpn_dim]
        self.num_layers = num_layers
        for li in range(num_layers):
            self.add_module(f"layer_{li}",
                            BiFPNLayer(fpn_dim, chans, depthwise))
            chans = [fpn_dim] * len(chans)

    def forward(self, pyramid):
        p6 = self.downsize(self.p6_resample(pyramid[-1]))
        p7 = self.downsize(p6)
        feats = list(pyramid) + [p6, p7]
        for li in range(self.num_layers):
            feats = getattr(self, f"layer_{li}")(feats)
        return feats


class BiFPNDecoder(nn.Module):
    """Ladder decoder: from P7 upward, 2x transpose-conv + skip concat,
    finishing with a 5x5 separable fusion at P2 resolution."""

    def __init__(self, fpn_dim=160, n_fpn_scales=5):
        super().__init__()
        self.n_fpn_scales = n_fpn_scales
        for i in range(n_fpn_scales):
            nin = fpn_dim if i == 0 else 2 * fpn_dim
            self.add_module(f"up_{i}", ConvTransposeBNAct(nin, fpn_dim, 2))
        self.fusion = SeparableConvBNAct(2 * fpn_dim, fpn_dim, 5)

    def forward(self, fpn_features):
        # fpn_features ordered smallest-resolution first (P7 ... P3, P2)
        assert len(fpn_features) == self.n_fpn_scales + 1
        x = fpn_features[0]
        for i, skip in enumerate(fpn_features[1:]):
            x = getattr(self, f"up_{i}")(x)
            x = torch.cat([x, skip], dim=1)
        return self.fusion(x)
