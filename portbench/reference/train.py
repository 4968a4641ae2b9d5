"""Plain reference of the training step: the Panoptic-DeepLab loss with
PointRend, AdamW with decoupled weight decay (none on biases and batch
norm), and the one-cycle learning rate, in float32 (TF32 off).

``run_steps`` trains the reference model through the given batches and
returns what the check compares: each step's loss, each leaf's first
gradient, and each leaf's change over the steps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["panoptic_loss", "one_cycle", "decays", "run_steps"]


def _bce(logits, labels):
    return F.binary_cross_entropy_with_logits(logits, labels,
                                              reduction="none")


def panoptic_loss(out, batch, weights):
    """Weighted bootstrapped BCE (top-k share of the batch's pixels),
    center-heatmap MSE, offset L1 over the foreground and PointRend BCE
    at the nearest label of each point."""
    sem = batch["sem"].float()
    pixel = _bce(out["sem_logits"][:, 0].float(), sem).reshape(-1)
    k = max(1, int(weights["top_k_percent"] * pixel.numel()))
    ce = torch.topk(pixel, k, sorted=False).values.mean()
    mse = torch.mean((out["ctr_hmp"].float() - batch["ctr_hmp"]) ** 2)
    fg = (sem > 0)[:, None].float()
    wsum = fg.sum()
    l1 = (torch.abs(out["offsets"].float() - batch["offsets"]) * fg).sum() \
        / wsum.clamp(min=1) if float(wsum) > 0 else wsum * 0
    n, h, w = sem.shape
    c = out["point_coords"]
    xi = torch.round(c[..., 0] * w - 0.5).long().clamp(0, w - 1)
    yi = torch.round(c[..., 1] * h - 0.5).long().clamp(0, h - 1)
    labels = torch.gather(sem.reshape(n, h * w), 1, yi * w + xi)
    pr = _bce(out["sem_points"][..., 0].float(), labels).mean()
    return (weights["ce_weight"] * ce + weights["mse_weight"] * mse
            + weights["l1_weight"] * l1 + weights["pr_weight"] * pr)


def one_cycle(step, total, max_lr, pct_start=0.3, div_factor=25.0,
              final_div_factor=1e4):
    """Cosine one-cycle rate at ``step`` (0-based) of ``total``."""
    initial = max_lr / div_factor
    final = initial / final_div_factor
    up = max(pct_start * total, 1e-6)
    if step < up:
        t = min(max(step / up, 0.0), 1.0)
        return initial + (max_lr - initial) * 0.5 * (1 - math.cos(math.pi * t))
    t = min(max((step - up) / max(total - up, 1e-6), 0.0), 1.0)
    return final + (max_lr - final) * 0.5 * (1 + math.cos(math.pi * t))


def decays(name):
    """Weight decay applies to every parameter but biases and batch-norm
    parameters."""
    parts = name.split(".")
    return not (parts[-1] == "bias" or any("BatchNorm" in p for p in parts))


def run_steps(model, batches, coords, recipe, total_steps, rows=None):
    """Train ``model`` (train mode, its initial state loaded) one step per
    batch. ``batches``: dicts of NCHW float32 device tensors ``image``,
    ``sem`` (N, H, W), ``ctr_hmp``, ``offsets``; ``coords``: (N, P, 2)
    PointRend points per batch; ``rows``: keep only these rows of each
    batch (a planted fault). Returns {"loss": [per step], "grad":
    {leaf: norm of the first gradient}, "change": {leaf: norm of the
    change}}."""
    weights = recipe["TRAIN"]["criterion_params"]
    opt = recipe["TRAIN"]["optimizer_params"]
    sched = recipe["TRAIN"]["schedule_params"]
    b1, b2 = opt.get("betas", (0.9, 0.999))
    eps, wd = opt.get("eps", 1e-8), opt["weight_decay"]
    params = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for t, (batch, pts) in enumerate(zip(batches, coords), 1):
        if rows is not None:
            batch = {k: x[rows] for k, x in batch.items()}
            pts = pts[rows]
        model.zero_grad(set_to_none=True)
        loss = panoptic_loss(model(batch["image"], pts), batch, weights)
        loss.backward()
        losses.append(float(loss.detach()))
        lr = one_cycle(t - 1, total_steps, sched["max_lr"],
                       sched.get("pct_start", 0.3),
                       sched.get("div_factor", 25.0),
                       sched.get("final_div_factor", 1e4))
        with torch.no_grad():
            if first is None:
                first = {k: float(p.grad.norm()) for k, p in params.items()}
            for k, p in params.items():
                g = p.grad
                if decays(k):
                    p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[k] / (1 - b1 ** t)
                vhat = v[k] / (1 - b2 ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in params.items()}
    return {"loss": losses, "grad": first, "change": change}
