"""Prediction heads (NCHW): 5x5 separable conv-bn-relu, then a 1x1 conv
with bias."""

from __future__ import annotations

from torch import nn

from empanada_torch.models.blocks import Conv2d, SeparableConvBNAct

__all__ = ["PanopticDeepLabHead"]


class PanopticDeepLabHead(nn.Module):
    def __init__(self, in_features, n_classes):
        super().__init__()
        self.SeparableConvBNAct_0 = SeparableConvBNAct(in_features,
                                                       in_features, 5)
        self.Conv_0 = Conv2d(in_features, n_classes, 1)

    def forward(self, x):
        return self.Conv_0(self.SeparableConvBNAct_0(x))
