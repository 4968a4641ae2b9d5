"""Optimizers and LR schedules (torch.optim).

The JAX package's recipes by name: OneCycle / cosine / multi-step /
constant schedules as functions of the optimizer step, and AdamW / Adam
/ SGD with a weight-decay split that exempts biases and batch-norm
parameters, plus clipping by global norm.

The schedules are evaluated in float32 in the JAX package's order of
operations, with each cosine correctly rounded to float32 (computed in
float64): each step's rate is the JAX package's to float32 rounding of
the peak rate, and exactly equal at most steps (the two float32 cosines
differ by one unit in the last place at a few arguments). ``_one_cycle`` is hand-rolled (cosine annealing, phase ends at
``pct_start * total`` and ``total``); it is not
``torch.optim.lr_scheduler.OneCycleLR``, whose phase ends differ by one
step. Torch drives it through ``LambdaLR`` over a base rate of 1.
"""

from __future__ import annotations

import math

import torch

__all__ = ["create_lr_schedule", "decay_mask", "configure_optimizer",
           "clip_by_global_norm_"]


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _cos(t):
    """float32 cosine of a float32 tensor, correctly rounded."""
    return _f32(math.cos(float(t)))


def _one_cycle(total_steps, max_lr, pct_start=0.3, div_factor=25.0,
               final_div_factor=1e4):
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up_steps = max(pct_start * total_steps, 1e-6)
    down_steps = max(total_steps - up_steps, 1e-6)

    def schedule(step):
        step = _f32(float(step))
        up_t = torch.clamp(step / _f32(up_steps), 0.0, 1.0)
        up = _f32(initial) + _f32((max_lr - initial) * 0.5) * (
            1.0 - _cos(_f32(math.pi) * up_t))
        down_t = torch.clamp((step - _f32(up_steps)) / _f32(down_steps),
                             0.0, 1.0)
        down = _f32(final) + _f32((max_lr - final) * 0.5) * (
            1.0 + _cos(_f32(math.pi) * down_t))
        return float(up if step < up_steps else down)

    return schedule


def _cosine(init_value, decay_steps):
    def schedule(step):
        if decay_steps <= 0:
            return float(_f32(init_value))
        count = _f32(float(min(step, decay_steps)))
        cosine = 0.5 * (1 + _cos(_f32(math.pi) * count
                                 / _f32(decay_steps)))
        return float(_f32(init_value) * cosine)

    return schedule


def _multi_step(lr, boundaries_and_scales):
    def schedule(step):
        v = _f32(lr)
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if step >= threshold:
                v = v * _f32(scale)
        return float(v)

    return schedule


def create_lr_schedule(name, loader_steps, **params):
    """Schedule factory: a function step -> learning rate.
    ``loader_steps`` (the loader's steps per epoch) stands in for the
    recipes' ``steps_per_epoch: -1``; a positive one in ``params``
    wins."""
    steps_per_epoch = params.pop("steps_per_epoch", -1)
    if not steps_per_epoch or steps_per_epoch <= 0:
        steps_per_epoch = loader_steps
    if name == "OneCycleLR":
        total = max(int(params.get("epochs", 1) * steps_per_epoch), 2)
        return _one_cycle(
            total_steps=total,
            max_lr=params.get("max_lr", 3e-3),
            pct_start=params.get("pct_start", 0.3),
            div_factor=params.get("div_factor", 25.0),
            final_div_factor=params.get("final_div_factor", 1e4))
    if name == "CosineAnnealingLR":
        return _cosine(params["lr"],
                       int(params.get("T_max", 1) * steps_per_epoch))
    if name == "MultiStepLR":
        gamma = params.get("gamma", 0.1)
        return _multi_step(params["lr"], {
            int(m * steps_per_epoch): gamma
            for m in params.get("milestones", [])})
    if name in ("constant", "ConstantLR"):
        lr = float(params.get("lr", 1e-3))
        return lambda step: lr
    raise ValueError(f"unknown lr schedule {name!r}")


def decay_mask(named_params):
    """{name: True where weight decay applies}: every parameter but
    biases and batch-norm parameters, judged on the flax path's names
    (the port's modules carry them: ``BatchNorm_0``, ``bias``)."""
    out = {}
    for name, _ in named_params:
        parts = name.split(".")
        out[name] = not (parts[-1] == "bias" or any(
            "BatchNorm" in p or p == "bn" for p in parts))
    return out


def configure_optimizer(named_params, opt_name, grad_clip=None,
                        **opt_params):
    """A torch optimizer for (name, parameter) pairs, as two param groups
    (decay, no decay) at a base rate of 1: drive the rate with
    ``LambdaLR(optimizer, schedule)``. ``grad_clip`` (the recipes' key
    among the optimizer's parameters) is the caller's: pass it to
    ``clip_by_global_norm_`` before each step.

    AdamW decays by lr * wd * p (optax.adamw); Adam and SGD add wd * p
    to the gradient (optax.add_decayed_weights chained before them)."""
    named_params = list(named_params)
    opt_params = dict(opt_params)
    wd = opt_params.pop("weight_decay", 0.0)
    opt_params.pop("lr", None)  # the schedule wins
    mask = decay_mask(named_params)
    groups = [
        {"params": [p for n, p in named_params if mask[n]],
         "weight_decay": wd},
        {"params": [p for n, p in named_params if not mask[n]],
         "weight_decay": 0.0},
    ]
    groups = [g for g in groups if g["params"]]
    if opt_name == "AdamW":
        betas = tuple(opt_params.pop("betas", (0.9, 0.999)))
        opt = torch.optim.AdamW(groups, lr=1.0, betas=betas,
                                eps=opt_params.pop("eps", 1e-8))
    elif opt_name == "Adam":
        opt = torch.optim.Adam(groups, lr=1.0)
    elif opt_name == "SGD":
        opt = torch.optim.SGD(groups, lr=1.0,
                              momentum=opt_params.pop("momentum", 0.0),
                              nesterov=opt_params.pop("nesterov", False))
    else:
        raise ValueError(f"unknown optimizer {opt_name!r}")
    return opt


@torch.no_grad()
def clip_by_global_norm_(params, max_norm):
    """optax.clip_by_global_norm: scale every gradient by
    max_norm / global_norm when the global norm is at least max_norm
    (no epsilon, unlike torch.nn.utils.clip_grad_norm_). Returns the
    global norm as a tensor (no host synchronization)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
