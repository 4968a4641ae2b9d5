"""ResNet / ResNeXt / Wide-ResNet encoders (NCHW).

Single-channel images -> the 5-level pyramid [p1..p5] at strides
[4, 4, 8, 16, 32]: a 7x7 stride-2 stem conv (``stem``) with its batch
norm (``BatchNorm_0``) and a 3x3 stride-2 max-pool (padding 1), then
four stages of basic or bottleneck blocks. ``output_stride=16`` makes
stage 4 stride 1 with dilation 2 in every block (its 1x1 downsample
stays stride 1). Children carry the flax names of the JAX package's
modules (``layer{i}_block{j}``, ``Conv_k``, ``BatchNorm_k``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from empanada_torch.models.blocks import Conv2d, bn, cast

__all__ = [
    "ResNet", "ResNetConfig", "BasicBlock", "BottleneckBlock",
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "resnext50_32x4d", "resnext101_32x8d",
    "wide_resnet50_2", "wide_resnet101_2",
]


@dataclasses.dataclass
class ResNetConfig:
    layers: Sequence[int]
    block: str  # 'basic' | 'bottleneck'
    groups: int = 1
    width_per_group: int = 64
    w_stem: int = 64

    def __post_init__(self):
        expansion = 1 if self.block == "basic" else 4
        self.widths = [64 * expansion, 128 * expansion,
                       256 * expansion, 512 * expansion]


def _conv(in_features, features, kernel, stride=1, dilation=1, groups=1):
    pad = dilation * (kernel - 1) // 2
    return Conv2d(in_features, features, kernel, stride, pad,
                  dilation=dilation, groups=groups, bias=False)


class BasicBlock(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, in_features, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        self.Conv_0 = _conv(in_features, planes, 3, stride, dilation)
        self.BatchNorm_0 = bn(planes)
        self.Conv_1 = _conv(planes, planes, 3, 1, dilation)
        self.BatchNorm_1 = bn(planes)
        if downsample:
            self.Conv_2 = _conv(in_features, planes, 1, stride)
            self.BatchNorm_2 = bn(planes)
        self.downsample = downsample

    def forward(self, x):
        dt = self.compute_dtype
        out = cast(F.relu(self.BatchNorm_0(self.Conv_0(x))), dt)
        out = cast(self.BatchNorm_1(self.Conv_1(out)), dt)
        if self.downsample:
            x = cast(self.BatchNorm_2(self.Conv_2(x)), dt)
        return F.relu(out + x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (grouped, strided, dilated) -> 1x1 to ``planes * 4``;
    the inner width is ``int(planes * width_per_group / 64) * groups``."""

    compute_dtype = torch.float32

    def __init__(self, in_features, planes, stride=1, dilation=1, groups=1,
                 base_width=64, downsample=False):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * 4
        self.Conv_0 = _conv(in_features, width, 1)
        self.BatchNorm_0 = bn(width)
        self.Conv_1 = _conv(width, width, 3, stride, dilation, groups)
        self.BatchNorm_1 = bn(width)
        self.Conv_2 = _conv(width, out_ch, 1)
        self.BatchNorm_2 = bn(out_ch)
        if downsample:
            self.Conv_3 = _conv(in_features, out_ch, 1, stride)
            self.BatchNorm_3 = bn(out_ch)
        self.downsample = downsample

    def forward(self, x):
        dt = self.compute_dtype
        out = cast(F.relu(self.BatchNorm_0(self.Conv_0(x))), dt)
        out = cast(F.relu(self.BatchNorm_1(self.Conv_1(out))), dt)
        out = cast(self.BatchNorm_2(self.Conv_2(out)), dt)
        if self.downsample:
            x = cast(self.BatchNorm_3(self.Conv_3(x)), dt)
        return F.relu(out + x)


class ResNet(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, cfg: ResNetConfig, output_stride: int = 32):
        super().__init__()
        assert output_stride in (16, 32), output_stride
        self.cfg = cfg
        self.stem = _conv(1, cfg.w_stem, 7, stride=2)
        self.BatchNorm_0 = bn(cfg.w_stem)
        planes = [64, 128, 256, 512]
        strides = [1, 2, 2, 2 if output_stride == 32 else 1]
        dilations = [1, 1, 1, 1 if output_stride == 32 else 2]
        expansion = 1 if cfg.block == "basic" else 4
        in_ch = cfg.w_stem
        self.block_names = []
        for si in range(4):
            names = []
            for bi in range(cfg.layers[si]):
                stride = strides[si] if bi == 0 else 1
                out_ch = planes[si] * expansion
                needs_ds = bi == 0 and (stride != 1 or in_ch != out_ch)
                if cfg.block == "basic":
                    block = BasicBlock(in_ch, planes[si], stride,
                                       dilations[si], needs_ds)
                else:
                    block = BottleneckBlock(
                        in_ch, planes[si], stride, dilations[si],
                        cfg.groups, cfg.width_per_group, needs_ds)
                name = f"layer{si + 1}_block{bi + 1}"
                self.add_module(name, block)
                names.append(name)
                in_ch = out_ch
            self.block_names.append(names)
        self.out_channels = [cfg.w_stem] + list(cfg.widths)

    def forward(self, x):
        out = cast(F.relu(self.BatchNorm_0(self.stem(x))), self.compute_dtype)
        out = F.max_pool2d(out, 3, stride=2, padding=1)
        features = [out]
        for names in self.block_names:
            for name in names:
                out = getattr(self, name)(out)
            features.append(out)
        return features


def _mk(layers, block, groups=1, width_per_group=64, **kw):
    return ResNet(ResNetConfig(layers=layers, block=block, groups=groups,
                               width_per_group=width_per_group), **kw)


def resnet18(**kw):
    return _mk([2, 2, 2, 2], "basic", **kw)


def resnet34(**kw):
    return _mk([3, 4, 6, 3], "basic", **kw)


def resnet50(**kw):
    return _mk([3, 4, 6, 3], "bottleneck", **kw)


def resnet101(**kw):
    return _mk([3, 4, 23, 3], "bottleneck", **kw)


def resnet152(**kw):
    return _mk([3, 8, 36, 3], "bottleneck", **kw)


def resnext50_32x4d(**kw):
    return _mk([3, 4, 6, 3], "bottleneck", groups=32, width_per_group=4, **kw)


def resnext101_32x8d(**kw):
    return _mk([3, 4, 23, 3], "bottleneck", groups=32, width_per_group=8,
               **kw)


def wide_resnet50_2(**kw):
    return _mk([3, 4, 6, 3], "bottleneck", width_per_group=128, **kw)


def wide_resnet101_2(**kw):
    return _mk([3, 4, 23, 3], "bottleneck", width_per_group=128, **kw)
