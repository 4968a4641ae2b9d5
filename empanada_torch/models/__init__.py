"""Model registry (config arch strings -> module classes): the
Panoptic-BiFPN family (MitoNet) and the Panoptic-DeepLab family (PDL,
PDL-PR, PDL-BC), and the two inits: a
signal-carrying one for inference checks (``init_random_``) and the JAX
package's ``model.init`` distributions for training (``init_train_``)."""

from __future__ import annotations

import inspect
import math
import re

import torch
from torch import nn

from empanada_torch.device import resolve_device
from empanada_torch.models.blocks import (
    ConvBNAct,
    ConvTransposeBNAct,
    SeparableConvBNAct,
    SqueezeExcite,
    set_compute_dtype,
)
from empanada_torch.models.decoders.aspp import ASPP
from empanada_torch.models.decoders.panoptic_deeplab import (
    PanopticDeepLabDecoder,
)
from empanada_torch.models.encoders.regnet import Bottleneck
from empanada_torch.models.encoders.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
)
from empanada_torch.models.heads import PanopticDeepLabHead
from empanada_torch.models.panoptic_bifpn import PanopticBiFPN, PanopticBiFPNPR
from empanada_torch.models.panoptic_deeplab import (
    PanopticDeepLab,
    PanopticDeepLabBC,
    PanopticDeepLabPR,
)
from empanada_torch.models.point_rend import StandardPointHead

MODELS = {
    "PanopticDeepLab": PanopticDeepLab,
    "PanopticDeepLabPR": PanopticDeepLabPR,
    "PanopticDeepLabBC": PanopticDeepLabBC,
    "PanopticBiFPN": PanopticBiFPN,
    "PanopticBiFPNPR": PanopticBiFPNPR,
    # the reference's quantizable trees carry these arch names; any model
    # here quantizes through models.quantization, so they resolve to the
    # same classes, as in the JAX registry
    "QuantizablePanopticDeepLab": PanopticDeepLab,
    "QuantizablePanopticDeepLabPR": PanopticDeepLabPR,
    "QuantizablePanopticBiFPN": PanopticBiFPN,
    "QuantizablePanopticBiFPNPR": PanopticBiFPNPR,
}


def create_model(arch: str, device=None, seed=None, init="random",
                 dtype="float32", **kwargs):
    """Build ``arch`` in eval mode on ``device`` (CUDA unless the caller
    names another; raises without a card when none is named).

    ``dtype`` ("float32" / "fp32" / "bfloat16" / "bf16", the recipe's
    ``MODEL.dtype``) is the compute dtype, as the JAX registry builds
    ``cls(dtype=dtype)``: convolutions and dense layers compute in it,
    batch norm in float32, parameters and statistics stay float32
    (``blocks.set_compute_dtype``). float32 is the parity mode.

    ``seed`` makes the init reproducible through an explicit
    ``torch.Generator``: ``init="random"`` is ``init_random_``,
    ``init="train"`` is ``init_train_``. Reference-only kwargs (the
    quantized aliases' extras) are accepted and ignored, like the JAX
    registry."""
    if arch not in MODELS:
        raise ValueError(f"unknown arch {arch!r}; choices: {sorted(MODELS)}")
    device = resolve_device(device)
    cls = MODELS[arch]
    valid = set(inspect.signature(cls.__init__).parameters) - {"self"}
    model = cls(**{k: v for k, v in kwargs.items() if k in valid})
    if seed is not None:
        {"random": init_random_, "train": init_train_}[init](model, seed)
    set_compute_dtype(model, dtype)
    return model.to(device).eval()


@torch.no_grad()
def init_random_(model: torch.nn.Module, seed: int):
    """Seeded init: kaiming-normal (fan_out) conv/linear weights, small
    random biases and batch-norm statistics, so every layer carries
    signal. Values come from one CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        if t.ndim >= 2:
            fan_out = t.shape[0] * (t[0, 0].numel() if t.ndim > 2 else 1)
            std = (2.0 / fan_out) ** 0.5
            t.copy_(torch.randn(t.shape, generator=gen) * std)
        elif name.endswith("running_var"):
            t.copy_(1.0 + 0.1 * torch.rand(t.shape, generator=gen))
        elif name.endswith("fusion_weights"):
            t.fill_(1.0)
        elif name.endswith("weight"):
            t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen))
        else:
            t.copy_(0.05 * torch.randn(t.shape, generator=gen))


def _normal_(t, std, gen):
    t.copy_(torch.randn(t.shape, generator=gen) * std)


def _fans(t):
    """(fan_in, fan_out) of a torch conv / linear weight, as flax counts
    them for the same kernel (receptive field x channels)."""
    rf = t[0, 0].numel() if t.ndim > 2 else 1
    return t.shape[1] * rf, t.shape[0] * rf


def _kaiming_fan_out_(t, gen):
    """flax ``variance_scaling(2.0, "fan_out", "normal")``."""
    _normal_(t, math.sqrt(2.0 / _fans(t)[1]), gen)


def _glorot_uniform_(t, gen):
    """flax ``variance_scaling(1.0, "fan_avg", "uniform")``."""
    limit = math.sqrt(6.0 / sum(_fans(t)))
    t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * limit)


@torch.no_grad()
def init_train_(model: torch.nn.Module, seed: int):
    """The JAX package's ``model.init`` distributions, for training from
    scratch: kaiming-normal (fan_out) convs (ResNet's included),
    glorot-uniform separable and transposed convs, std-0.001 normal
    heads, ASPP and Panoptic-DeepLab decoder convs (``head_normal``),
    kaiming-normal PointRend layers with a std-0.001 last layer, zero
    biases, BN scale 1 (0 on each RegNet bottleneck's last BN, flax's
    ``final_bn``), BN bias and running mean 0, running var 1 and BiFPN
    fusion weights 1. Values come from one CPU ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    for name, t in model.state_dict().items():
        if not t.is_floating_point():
            continue
        if name.endswith("running_var") or name.endswith("fusion_weights"):
            t.fill_(1.0)
        elif re.search(r"BatchNorm_\d+\.weight$", name):
            t.fill_(1.0)
        elif t.ndim < 2:
            t.zero_()
    # modules whose convs take head_normal: the heads' separable convs
    # and the Panoptic-DeepLab decoders' projections and fuses
    heads = {id(m.SeparableConvBNAct_0) for m in model.modules()
             if isinstance(m, PanopticDeepLabHead)}
    for dec in model.modules():
        if isinstance(dec, PanopticDeepLabDecoder):
            heads.update(id(child) for name, child in dec.named_children()
                         if name.startswith(("project_", "fuse_")))
    for mod in model.modules():
        if isinstance(mod, (ResNet, BasicBlock, BottleneckBlock)):
            for child in mod.children():
                if isinstance(child, nn.Conv2d):
                    _kaiming_fan_out_(child.weight, gen)
        elif isinstance(mod, ASPP):
            for child in mod.children():
                if isinstance(child, nn.Conv2d):
                    _normal_(child.weight, 0.001, gen)
        elif isinstance(mod, ConvBNAct):
            if id(mod) in heads:
                _normal_(mod.Conv_0.weight, 0.001, gen)
            else:
                _kaiming_fan_out_(mod.Conv_0.weight, gen)
        elif isinstance(mod, SeparableConvBNAct):
            for conv in (mod.Conv_0, mod.Conv_1):
                if id(mod) in heads:
                    _normal_(conv.weight, 0.001, gen)
                else:
                    _glorot_uniform_(conv.weight, gen)
        elif isinstance(mod, ConvTransposeBNAct):
            _glorot_uniform_(mod.ConvTranspose_0.weight, gen)
        elif isinstance(mod, SqueezeExcite):
            _kaiming_fan_out_(mod.Conv_0.weight, gen)
            _kaiming_fan_out_(mod.Conv_1.weight, gen)
        elif isinstance(mod, PanopticDeepLabHead):
            _normal_(mod.Conv_0.weight, 0.001, gen)
        elif isinstance(mod, StandardPointHead):
            for i in range(mod.num_fc):
                _kaiming_fan_out_(getattr(mod, f"Dense_{i}").weight, gen)
            _normal_(getattr(mod, f"Dense_{mod.num_fc}").weight, 0.001, gen)
        elif isinstance(mod, Bottleneck):
            mod.ConvBNAct_2.BatchNorm_0.weight.zero_()
