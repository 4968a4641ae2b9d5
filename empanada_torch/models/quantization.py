"""Executing int8 inference (post-training static quantization).

The JAX package's ``models/quantization.py`` in the port's terms (the
reference exports a quantized fbgemm model for CPU deployment: reference
empanada/models/quantization/panoptic_deeplab.py:170-250,
scripts/export_model.py:137-163):

- weights: per-output-channel symmetric int8 (``export.quantize_state_int8``);
- activations: per-tensor symmetric int8, scales calibrated by running
  the float32 model on sample data (``calibrate_activations``);
- compute: int8 x int8 -> int32 products (``ops/int8.py``), rescaled to
  float32; everything between the products (batch norm, resizes, NMS)
  stays float32.

``quantize_model`` swaps each ``nn.Conv2d`` / ``nn.Linear`` whose path has
a positive activation scale and whose weight is int8 in the artifact for
``Int8Conv2d`` / ``Int8Linear``; every other module keeps its float32
compute, so any model of the registry quantizes without a parallel
module tree. Module paths are the JAX package's ``a/b/c`` (the port's
dotted names with ``/``), so a JAX descriptor's ``act_scales`` apply as
they are.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from empanada_torch.export import (
    INT8_SUFFIX,
    SCALE_SUFFIX,
    dequantize_state_int8,
)
from empanada_torch.ops.int8 import int8_conv2d, int8_linear

__all__ = ["calibrate_activations", "Int8Conv2d", "Int8Linear",
           "quantize_model", "int8_conv_count"]


def _path(name):
    return name.replace(".", "/")


def calibrate_activations(model, batches, percentile=99.99,
                          forward_kwargs=None):
    """Run the float32 model on ``batches`` (NCHW tensors on the model's
    device) and record each ``nn.Conv2d`` / ``nn.Linear`` input range ->
    {module path: activation scale}.

    As the JAX package: every call of a module keeps a strided sample of
    its input's absolute values (flattened in NHWC order, the flax
    layout, every ``size // 65536``-th), and the percentile is taken over
    the pooled samples; 100.0 takes the exact max. scale = value / 127.
    """
    forward_kwargs = dict(forward_kwargs or {})
    records = {}

    def hook(name):
        def pre_hook(module, args):
            x = args[0].detach().float()
            if x.ndim == 4:
                x = x.permute(0, 2, 3, 1)  # NCHW -> flax's NHWC
            a = x.abs().reshape(-1)
            if percentile >= 100.0:
                sample = a.max().reshape(1)
            else:
                sample = a[::max(1, a.shape[0] // 65536)]
            records.setdefault(name, []).append(
                sample.cpu().numpy().astype(np.float32))
        return pre_hook

    handles = [m.register_forward_pre_hook(hook(_path(name)))
               for name, m in model.named_modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for batch in batches:
                model(batch, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)

    scales = {}
    for path, samples in records.items():
        pooled = np.concatenate(samples)
        m = float(np.max(pooled)) if percentile >= 100.0 \
            else float(np.percentile(pooled, percentile))
        if m > 0:
            scales[path] = m / 127.0
    return scales


class _Int8Base(nn.Module):
    """int8 weights (O, ...), per-output-channel float32 scales (O,), the
    activation scale and the float32 bias of the module it replaces."""

    def __init__(self, w8, w_scale, act_scale, bias):
        super().__init__()
        self.register_buffer("weight_int8", w8)
        self.register_buffer("weight_scale", w_scale)
        self.register_buffer("act_scale",
                             torch.tensor(act_scale, dtype=torch.float32))
        self.register_buffer("bias", bias)

    def quantize_input(self, x):
        # a device tensor, not a Python float: CUDA divides by a host
        # scalar as a product with its reciprocal, which rounds otherwise
        xq = torch.round(x.float() / self.act_scale)
        return torch.clamp(xq, -127, 127).to(torch.int8)

    def rescale(self, acc, shape):
        y = acc.float() * (self.act_scale * self.weight_scale).reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y


class Int8Conv2d(_Int8Base):
    """``nn.Conv2d`` on int8 activations and weights, int32 sums."""

    def __init__(self, conv, w8, w_scale, act_scale):
        super().__init__(w8, w_scale, act_scale,
                         None if conv.bias is None
                         else conv.bias.detach().float().clone())
        self.stride, self.padding = conv.stride, conv.padding
        self.dilation, self.groups = conv.dilation, conv.groups

    def forward(self, x):
        dtype = x.dtype
        acc = int8_conv2d(self.quantize_input(x), self.weight_int8,
                          self.stride, self.padding, self.dilation,
                          self.groups)
        return self.rescale(acc, (1, -1, 1, 1)).to(dtype)


class Int8Linear(_Int8Base):
    """``nn.Linear`` on int8 activations and weights, int32 sums."""

    def __init__(self, linear, w8, w_scale, act_scale):
        super().__init__(w8, w_scale, act_scale,
                         None if linear.bias is None
                         else linear.bias.detach().float().clone())

    def forward(self, x):
        dtype = x.dtype
        acc = int8_linear(self.quantize_input(x), self.weight_int8)
        return self.rescale(acc, (-1,)).to(dtype)


def quantize_model(model, int8_state, act_scales):
    """The counterpart of the JAX package's ``Int8Module``: load the int8
    artifact's state (``export.quantize_state_int8`` layout) into
    ``model`` and swap in the int8 modules, in place; returns ``model``.

    A ``nn.Conv2d`` / ``nn.Linear`` is swapped only where its path has a
    positive scale in ``act_scales`` and its weight is int8 in the
    artifact. Every other module keeps float32 compute: with its float
    weight, or its int8 weight dequantized where no scale is given."""
    act_scales = {k: float(v) for k, v in dict(act_scales).items()}
    swaps = []
    for name, mod in model.named_modules():
        if not isinstance(mod, (nn.Conv2d, nn.Linear)):
            continue
        key = f"{name}.weight"
        scale = act_scales.get(_path(name))
        if scale is None or scale <= 0 or key + INT8_SUFFIX not in int8_state:
            continue
        swaps.append((name, mod, scale))
    swapped = {f"{name}.weight" for name, _, _ in swaps}
    float_state = dequantize_state_int8(
        {k: v for k, v in int8_state.items()
         if k[: -len(INT8_SUFFIX)] not in swapped
         and k[: -len(SCALE_SUFFIX)] not in swapped})
    # placeholders for the weights of the modules to swap, so that
    # load_state_dict sees every key; the swap drops them
    for name, mod, _ in swaps:
        float_state[f"{name}.weight"] = torch.zeros_like(mod.weight)
    model.load_state_dict(float_state)

    device = next(model.parameters()).device
    for name, mod, scale in swaps:
        key = f"{name}.weight"
        w8 = int8_state[key + INT8_SUFFIX].to(device)
        ws = int8_state[key + SCALE_SUFFIX].to(device=device,
                                               dtype=torch.float32)
        cls = Int8Conv2d if isinstance(mod, nn.Conv2d) else Int8Linear
        new = cls(mod, w8, ws, scale).to(device)
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, child, new)
    return model


def int8_conv_count(model, x, **forward_kwargs):
    """How many int8 products one forward of ``model`` on ``x`` runs: the
    calls of its ``Int8Conv2d`` / ``Int8Linear`` modules, as the JAX
    package's ``int8_conv_count`` counts the int8 convolution and
    dot_general equations of the jaxpr."""
    count = 0

    def hook(module, args, output):
        nonlocal count
        count += 1

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Int8Conv2d, Int8Linear))]
    try:
        with torch.inference_mode():
            model(x, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    return count
