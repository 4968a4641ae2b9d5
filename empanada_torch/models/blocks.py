"""Shared conv blocks (NCHW nn.Modules).

Each block registers its children under the names the JAX package's
flax tree uses (``Conv_0``, ``BatchNorm_0``, ...), so a flax variable
path maps to a state_dict key by joining the names with dots
(``empanada_torch.weights.flax_to_torch``). Batch norm runs with flax's
epsilon (1e-5); in train mode it updates its running statistics as
flax's ``nn.BatchNorm`` does (``FlaxBatchNorm2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empanada_torch.ops.resize import interpolate_scale

__all__ = [
    "ConvBNAct",
    "SeparableConvBNAct",
    "ConvTransposeBNAct",
    "SqueezeExcite",
    "Resample2d",
    "Interpolate2d",
    "Resize2d",
    "FlaxBatchNorm2d",
]

BN_EPS = 1e-5  # flax.linen.BatchNorm default
BN_MOMENTUM = 0.1  # torch's convention for flax's momentum=0.9


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode running variance moves by the BIASED
    batch variance, as flax's ``nn.BatchNorm`` (momentum 0.9) updates
    ``batch_stats.var``; torch's own update uses the unbiased variance.
    Normalization (biased variance, eps 1e-5), the running mean, the
    eval mode and the state-dict keys are torch's unchanged."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        # torch moves a copy of the variance by 0.1 * var * n / (n - 1);
        # the stored one takes that new term rescaled to the biased
        # variance (autograd saves the copy, so this is no in-place
        # change of a saved tensor)
        var = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, var, self.weight,
                           self.bias, True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            keep = 1.0 - self.momentum
            new_term = var - keep * self.running_var
            self.running_var.mul_(keep).add_(new_term, alpha=(n - 1) / n)
            self.num_batches_tracked.add_(1)
        return out


def _bn(features):
    return FlaxBatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNAct(nn.Module):
    """conv -> BN -> activation. Grouped-conv capable (cuDNN takes any
    group width as it is)."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 groups=1, act=F.relu):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size, stride,
                                pad, groups=groups, bias=False)
        self.BatchNorm_0 = _bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return self.act(x) if self.act is not None else x


class SeparableConvBNAct(nn.Module):
    """depthwise conv -> pointwise conv -> BN -> activation."""

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 act=F.relu):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = nn.Conv2d(in_features, in_features, kernel_size,
                                stride, pad, groups=in_features, bias=False)
        self.Conv_1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = _bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_1(self.Conv_0(x)))
        return self.act(x) if self.act is not None else x


class ConvTransposeBNAct(nn.Module):
    """stride == kernel transposed conv -> BN -> activation (2x upsample)."""

    def __init__(self, in_features, features, kernel_size=2, act=F.relu):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            in_features, features, kernel_size, stride=kernel_size,
            bias=False)
        self.BatchNorm_0 = _bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.ConvTranspose_0(x))
        return self.act(x) if self.act is not None else x


class SqueezeExcite(nn.Module):
    """Global-pool squeeze-excite with fixed ratio 4."""

    def __init__(self, features):
        super().__init__()
        self.Conv_0 = nn.Conv2d(features, features // 4, 1)
        self.Conv_1 = nn.Conv2d(features // 4, features, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.Conv_1(F.relu(self.Conv_0(s))))
        return x * s


class Resample2d(nn.Module):
    """1x1 conv-bn channel/stride resample; identity when shapes match
    (and then it holds no parameters, like the flax module)."""

    def __init__(self, in_features, features, stride=1, act=None):
        super().__init__()
        if in_features == features and stride == 1:
            self.ConvBNAct_0 = None
        else:
            self.ConvBNAct_0 = ConvBNAct(in_features, features, 1, stride,
                                         act=act)

    def forward(self, x):
        return x if self.ConvBNAct_0 is None else self.ConvBNAct_0(x)


class Interpolate2d(nn.Module):
    def __init__(self, scale_factor, align_corners=False):
        super().__init__()
        self.scale_factor = scale_factor
        self.align_corners = align_corners

    def forward(self, x):
        return interpolate_scale(x, self.scale_factor, self.align_corners)


class Resize2d(nn.Module):
    """2x resize: nearest upsample or stride-2 3x3 maxpool downsample."""

    def __init__(self, scale_factor, up_or_down="up"):
        super().__init__()
        self.scale_factor = scale_factor
        self.up_or_down = up_or_down

    def forward(self, x):
        s = self.scale_factor
        if self.up_or_down == "up":
            return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        return F.max_pool2d(x, 3, stride=s, padding=1)
