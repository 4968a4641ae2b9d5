"""RegNetX/Y encoders (NCHW).

Quantized width rules (arXiv 2003.13678, eqns 2-4) generate 4 stages of
bottleneck blocks (bottle_ratio 1) with optional squeeze-excite; stem +
4 stages give a 5-level pyramid at strides [2, 4, 8, 16, 32]. MitoNet's
backbone is regnety_6p4gf (SE on, group width 72).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.nn.functional as F
from torch import nn

from empanada_torch.models.blocks import ConvBNAct, Resample2d, SqueezeExcite

__all__ = [
    "RegNet", "RegNetConfig",
    "regnetx_6p4gf", "regnety_200mf", "regnety_800mf", "regnety_3p2gf",
    "regnety_4gf", "regnety_6p4gf", "regnety_8gf", "regnety_16gf",
]


@dataclasses.dataclass
class RegNetConfig:
    """Quantized-width parameter generator."""
    depth: int
    w_0: int
    w_a: float
    w_m: float
    group_w: int
    q: int = 8
    use_se: bool = False
    w_stem: int = 32
    bottle_ratio: int = 1

    def __post_init__(self):
        assert self.w_a >= 0 and self.w_0 > 0 and self.w_m > 1
        assert self.w_0 % self.q == 0

        u = self.w_0 + np.arange(self.depth) * self.w_a
        s = np.round(np.log(u / self.w_0) / np.log(self.w_m))
        w = self.w_0 * np.power(self.w_m, s)
        w = self.q * np.round(w / self.q).astype(int)
        w, d = np.unique(w, return_counts=True)
        assert len(w) == 4, "only 4-stage networks supported"

        widths, groups = [], []
        for wi in w.tolist():
            w_b = int(max(1, wi * self.bottle_ratio))
            gw = int(min(self.group_w, w_b))
            m = np.lcm(gw, self.bottle_ratio) if self.bottle_ratio > 1 else gw
            w_b = max(m, int(m * round(w_b / m)))
            widths.append(int(w_b / self.bottle_ratio))
            groups.append(w_b // gw)

        self.widths = widths
        self.depths = d.tolist()
        self.groups = groups
        self.strides = [2, 2, 2, 2]


class Bottleneck(nn.Module):
    def __init__(self, in_features, features, groups=1, stride=1,
                 bottle_ratio=1.0, use_se=False):
        super().__init__()
        w_b = int(round(features * bottle_ratio))
        self.ConvBNAct_0 = ConvBNAct(in_features, w_b, 1)
        self.ConvBNAct_1 = ConvBNAct(w_b, w_b, 3, stride=stride,
                                     groups=groups)
        self.SqueezeExcite_0 = SqueezeExcite(w_b) if use_se else None
        self.ConvBNAct_2 = ConvBNAct(w_b, features, 1, act=None)
        self.Resample2d_0 = Resample2d(in_features, features, stride=stride)

    def forward(self, x):
        out = self.ConvBNAct_1(self.ConvBNAct_0(x))
        if self.SqueezeExcite_0 is not None:
            out = self.SqueezeExcite_0(out)
        out = self.ConvBNAct_2(out)
        return F.relu(self.Resample2d_0(x) + out)


class RegNet(nn.Module):
    """Single-channel images -> the 5-level pyramid [stem/2, s1/4, s2/8,
    s3/16, s4/32]. ``output_stride=16`` sets the last stage's stride to 1
    (no dilation, as in the JAX package and the reference)."""

    def __init__(self, cfg: RegNetConfig, output_stride: int = 32):
        super().__init__()
        assert output_stride in (16, 32), output_stride
        self.cfg = cfg
        strides = list(cfg.strides)
        if output_stride == 16:
            strides[-1] = 1
        self.stem = ConvBNAct(1, cfg.w_stem, 3, stride=2)
        self.block_names = []
        nin = cfg.w_stem
        for i in range(4):
            names = []
            for j in range(cfg.depths[i]):
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, Bottleneck(
                    nin, cfg.widths[i], groups=cfg.groups[i],
                    stride=strides[i] if j == 0 else 1,
                    bottle_ratio=cfg.bottle_ratio, use_se=cfg.use_se))
                nin = cfg.widths[i]
                names.append(name)
            self.block_names.append(names)
        self.out_channels = [cfg.w_stem] + list(cfg.widths)

    def forward(self, x):
        out = self.stem(x)
        features = [out]
        for names in self.block_names:
            for name in names:
                out = getattr(self, name)(out)
            features.append(out)
        return features


def _make(params, **kw):
    return RegNet(RegNetConfig(**params), **kw)


def regnetx_6p4gf(**kw):
    return _make(dict(depth=17, w_0=184, w_a=60.83, w_m=2.07, group_w=56),
                 **kw)


def regnety_200mf(**kw):
    return _make(dict(depth=13, w_0=24, w_a=36.44, w_m=2.49, group_w=8),
                 **kw)


def regnety_800mf(**kw):
    return _make(dict(depth=14, w_0=56, w_a=38.84, w_m=2.4, group_w=16),
                 **kw)


def regnety_3p2gf(**kw):
    return _make(dict(depth=21, w_0=80, w_a=42.63, w_m=2.66, group_w=24),
                 **kw)


def regnety_4gf(**kw):
    return _make(dict(depth=22, w_0=96, w_a=31.41, w_m=2.24, group_w=64),
                 **kw)


def regnety_6p4gf(**kw):
    return _make(dict(depth=25, w_0=112, w_a=33.22, w_m=2.27, group_w=72,
                      use_se=True), **kw)


def regnety_8gf(**kw):
    return _make(dict(depth=17, w_0=192, w_a=76.82, w_m=2.19, group_w=56,
                      use_se=True), **kw)


def regnety_16gf(**kw):
    return _make(dict(depth=18, w_0=200, w_a=106.23, w_m=2.48, group_w=112,
                      use_se=True), **kw)
