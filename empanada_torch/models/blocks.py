"""Shared conv blocks (NCHW nn.Modules).

Each block registers its children under the names the JAX package's
flax tree uses (``Conv_0``, ``BatchNorm_0``, ...), so a flax variable
path maps to a state_dict key by joining the names with dots
(``empanada_torch.weights.flax_to_torch``). Batch norm runs with flax's
epsilon (1e-5); in train mode it updates its running statistics as
flax's ``nn.BatchNorm`` does (``FlaxBatchNorm2d``), over the local
batch or, synchronized across data-parallel ranks
(``set_sync_batchnorm``), over the global one.

Compute dtype (flax's ``dtype=`` of every module, the registry's
``MODEL.dtype``): ``set_compute_dtype(model, "bfloat16")`` makes the
convolutions and dense layers (``Conv2d``, ``ConvTranspose2d``,
``Linear``: torch's layers with the same parameters) compute on
bfloat16 inputs and a bfloat16 copy of their float32 weights, batch
norm and the activation after it run in float32, and each block's
output is cast to bfloat16, where the JAX package's blocks cast. The
parameters and batch-norm statistics stay float32. A float32 model
casts nothing: its forward is the one it always was, bit for bit, and
the trainer's autocast runs over it unchanged.
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
    "bn",
    "set_sync_batchnorm",
    "Conv2d",
    "ConvTranspose2d",
    "Linear",
    "DTYPES",
    "set_compute_dtype",
    "cast",
    "promote",
]

BN_EPS = 1e-5  # flax.linen.BatchNorm default
BN_MOMENTUM = 0.1  # torch's convention for flax's momentum=0.9

# MODEL.dtype's names, as the JAX registry reads them
DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def set_compute_dtype(module, dtype):
    """Every submodule of ``module`` that has a compute dtype computes in
    ``dtype`` (a ``DTYPES`` name). Returns the module."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; choices: {sorted(DTYPES)}")
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = DTYPES[dtype]
    return module


def cast(x, dtype):
    """``x`` in the compute dtype ``dtype``, as a flax block's
    ``.astype(self.dtype)``; a float32 model casts nothing."""
    return x if dtype == torch.float32 else x.to(dtype)


def promote(x, dtype):
    """``x`` in float32 where the model computes in a narrower ``dtype``:
    jax promotes a bfloat16 activation scaled by a float32 parameter
    (the BiFPN's fusion weights) to float32, where torch keeps the
    activation's dtype for a 0-dim factor."""
    return x if dtype == torch.float32 else x.float()


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype`` (flax ``nn.Conv(dtype=)``):
    the input and a copy of the float32 weight and bias in that dtype."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in ``compute_dtype`` (flax
    ``nn.ConvTranspose(dtype=)``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax
    ``nn.Dense(dtype=)``)."""

    compute_dtype = torch.float32

    def forward(self, x):
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode running variance moves by the BIASED
    batch variance, as flax's ``nn.BatchNorm`` (momentum 0.9) updates
    ``batch_stats.var``; torch's own update uses the unbiased variance.
    Normalization (biased variance, eps 1e-5), the running mean, the
    eval mode and the state-dict keys are torch's unchanged.

    ``sync_world`` > 1 (``set_sync_batchnorm``) normalizes in train mode
    with the moments of the global batch of that many data-parallel
    ranks, as flax's BN under the JAX package's mesh: the per-rank sums
    of x and x^2 go through one autograd-aware all-reduce, the variance
    is flax's E[x^2] - E[x]^2 (clipped at 0), and the running variance
    moves by that biased global variance. A batch of one value a
    channel (a 1x1 map at batch 1, which torch's batch norm refuses) goes
    the same way without the all-reduce: flax normalizes it to the
    bias."""

    sync_world = 1
    compute_dtype = torch.float32

    def forward(self, x):
        # flax's BatchNorm(dtype=float32) in a bfloat16 model
        x = promote(x, self.compute_dtype)
        if not self.training:
            return super().forward(x)
        if self.sync_world > 1 or x.numel() == x.shape[1]:
            return self._sync_forward(x)
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

    def _sync_forward(self, x):
        c = x.shape[1]
        xf = x.float()
        n = xf.numel() // c * self.sync_world
        moments = torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))])
        if self.sync_world > 1:
            from torch.distributed.nn.functional import all_reduce

            moments = all_reduce(moments)
        moments = moments / n
        mean, sq = moments[:c], moments[c:]
        var = torch.clamp(sq - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            keep = 1.0 - self.momentum
            # through .data: a call of this module earlier in the same
            # forward (F.batch_norm on a larger map) saved running_mean for
            # its backward, which reads only the batch moments it saved
            self.running_mean.data.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def set_sync_batchnorm(module, world=1):
    """Every ``FlaxBatchNorm2d`` of ``module`` normalizes over the global
    batch of the ``world`` ranks of the default process group in train
    mode (world 1: its own batch, the default). Returns the module."""
    for m in module.modules():
        if isinstance(m, FlaxBatchNorm2d):
            m.sync_world = int(world)
    return module


def bn(features):
    """The port's batch norm with flax's epsilon and momentum."""
    return FlaxBatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvBNAct(nn.Module):
    """conv -> BN -> activation. Grouped-conv capable (cuDNN takes any
    group width as it is)."""

    compute_dtype = torch.float32

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 groups=1, act=F.relu):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = Conv2d(in_features, features, kernel_size, stride,
                             pad, groups=groups, bias=False)
        self.BatchNorm_0 = bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_0(x))
        return cast(self.act(x) if self.act is not None else x,
                    self.compute_dtype)


class SeparableConvBNAct(nn.Module):
    """depthwise conv -> pointwise conv -> BN -> activation."""

    compute_dtype = torch.float32

    def __init__(self, in_features, features, kernel_size=3, stride=1,
                 act=F.relu):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.Conv_0 = Conv2d(in_features, in_features, kernel_size,
                             stride, pad, groups=in_features, bias=False)
        self.Conv_1 = Conv2d(in_features, features, 1, bias=False)
        self.BatchNorm_0 = bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.Conv_1(self.Conv_0(x)))
        return cast(self.act(x) if self.act is not None else x,
                    self.compute_dtype)


class ConvTransposeBNAct(nn.Module):
    """stride == kernel transposed conv -> BN -> activation (2x upsample)."""

    compute_dtype = torch.float32

    def __init__(self, in_features, features, kernel_size=2, act=F.relu):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose2d(
            in_features, features, kernel_size, stride=kernel_size,
            bias=False)
        self.BatchNorm_0 = bn(features)
        self.act = act

    def forward(self, x):
        x = self.BatchNorm_0(self.ConvTranspose_0(x))
        return cast(self.act(x) if self.act is not None else x,
                    self.compute_dtype)


class SqueezeExcite(nn.Module):
    """Global-pool squeeze-excite with fixed ratio 4."""

    def __init__(self, features):
        super().__init__()
        self.Conv_0 = Conv2d(features, features // 4, 1)
        self.Conv_1 = Conv2d(features // 4, features, 1)

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
