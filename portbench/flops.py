"""Operations of a step, counted on the benchmark's plain reference model
at the cell's shapes, on the meta device (nothing is computed and no
memory is taken), so the count stays the same whatever a later change
does to the program's kernels.

Counted: the multiply-adds of every convolution, transposed convolution
and dense layer, two operations each, from their shapes:
``2 * N * C_out * H_out * W_out * (C_in / groups) * k_h * k_w`` (a
transposed convolution: the same over its input's positions), and for
a dense layer ``2 * rows * in * out``. Training adds the backward: the
gradient of the weight (as many operations again) and, where the input
takes a gradient, the gradient of the input (as many again). Batch norm,
activations, resizing and the loss are not counted.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from portbench.reference.models import build

__all__ = ["layer_flops", "model_flops", "train_step_flops"]


def layer_flops(module, x, y):
    """Forward operations of one layer on input ``x`` giving ``y``."""
    if isinstance(module, nn.ConvTranspose2d):
        cin, cout_g, kh, kw = module.weight.shape
        return 2 * x.shape[0] * x.shape[2] * x.shape[3] * cin * cout_g \
            * kh * kw
    if isinstance(module, nn.Conv2d):
        cout, cin_g, kh, kw = module.weight.shape
        return 2 * y.shape[0] * y.shape[2] * y.shape[3] * cout * cin_g \
            * kh * kw
    if isinstance(module, nn.Linear):
        rows = math.prod(x.shape[:-1])
        return 2 * rows * module.in_features * module.out_features
    return 0


def model_flops(model, *inputs, backward=False):
    """Operations of ``model(*inputs)`` (and of its backward)."""
    total = [0]

    def hook(module, args, out):
        f = layer_flops(module, args[0], out)
        if backward:
            f *= 2 + (1 if args[0].requires_grad else 0)
        total[0] += f

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def train_step_flops(cfg, batch, crop, points):
    """Forward and backward of one training step of ``cfg``'s model on a
    batch of ``batch`` images of ``crop``^2 with ``points`` PointRend
    points an image."""
    model = build(cfg, "meta")
    x = torch.empty((batch, 1, crop, crop), device="meta")
    coords = torch.empty((batch, points, 2), device="meta")
    return model_flops(model, x, coords, backward=True)
