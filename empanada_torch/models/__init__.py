"""Model registry (config arch strings -> module classes) for the MitoNet
slice: PanopticBiFPN and PanopticBiFPNPR."""

from __future__ import annotations

import inspect

import torch

from empanada_torch.device import resolve_device
from empanada_torch.models.panoptic_bifpn import PanopticBiFPN, PanopticBiFPNPR

MODELS = {
    "PanopticBiFPN": PanopticBiFPN,
    "PanopticBiFPNPR": PanopticBiFPNPR,
}


def create_model(arch: str, device=None, seed=None, **kwargs):
    """Build ``arch`` in eval mode on ``device`` (CUDA unless the caller
    names another; raises without a card when none is named).

    ``seed`` makes the random init reproducible through an explicit
    ``torch.Generator``. Reference-only kwargs (``dtype``, the quantized
    aliases' extras) are accepted and ignored, like the JAX registry."""
    if arch not in MODELS:
        raise ValueError(f"unknown arch {arch!r}; choices: {sorted(MODELS)}")
    device = resolve_device(device)
    cls = MODELS[arch]
    valid = set(inspect.signature(cls.__init__).parameters) - {"self"}
    model = cls(**{k: v for k, v in kwargs.items() if k in valid})
    if seed is not None:
        init_random_(model, seed)
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
