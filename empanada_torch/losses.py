"""Training losses (NCHW model outputs).

The JAX package's ``losses.py`` in PyTorch:

- ``bootstrap_ce``: (binary) cross-entropy averaged over the top-k%% of
  the per-pixel losses of the whole batch, k = int(pct * size);
- ``heatmap_mse``: MSE on center heatmaps;
- ``offset_l1``: L1 on offsets over the GT foreground, summed over both
  channels and divided by the mask's sum (0 for an empty mask);
- ``pointrend_loss``: CE between point logits and the GT sampled at the
  PointRend coordinates (nearest);
- ``PanopticLoss``: the weighted composite returning (total, aux).

C = 1 uses sigmoid BCE, C > 1 softmax CE. The losses run in float32
whatever the dtype of the model's outputs. ``BCLoss`` belongs to the
boundary-contour family, which is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "bootstrap_ce",
    "heatmap_mse",
    "offset_l1",
    "pointrend_loss",
    "point_sample_nearest",
    "PanopticLoss",
    "BCLoss",
    "LOSSES",
    "create_loss",
]


def _pixel_ce(logits, labels):
    """Per-pixel (binary) cross-entropy. logits (N, C, H, W); labels
    (N, H, W)."""
    logits = logits.float()
    if logits.shape[1] == 1:
        return F.binary_cross_entropy_with_logits(
            logits[:, 0], labels.float(), reduction="none")
    return F.cross_entropy(logits, labels.long(), reduction="none")


def bootstrap_ce(logits, labels, top_k_percent_pixels=0.2):
    """logits (N, C, H, W); labels (N, H, W)."""
    pixel_losses = _pixel_ce(logits, labels).reshape(-1)
    if top_k_percent_pixels >= 1.0:
        return pixel_losses.mean()
    k = max(1, int(top_k_percent_pixels * pixel_losses.numel()))
    return torch.topk(pixel_losses, k, sorted=False).values.mean()


def heatmap_mse(output, target):
    return torch.mean(torch.square(output.float() - target))


def offset_l1(output, target, offset_weights):
    """output, target (N, 2, H, W); offset_weights (N, 1, H, W)."""
    l1 = torch.abs(output.float() - target) * offset_weights
    weight_sum = offset_weights.sum()
    return torch.where(weight_sum == 0, torch.zeros_like(weight_sum),
                       l1.sum() / torch.clamp(weight_sum, min=1))


def point_sample_nearest(labels, point_coords):
    """(N, H, W) labels at (N, P, 2) coords (x, y) in [0, 1], nearest
    (round half to even, clipped to the grid). Returns (N, P) float."""
    n, h, w = labels.shape
    x = point_coords[..., 0] * w - 0.5
    y = point_coords[..., 1] * h - 0.5
    xi = torch.round(x).long().clamp(0, w - 1)
    yi = torch.round(y).long().clamp(0, h - 1)
    return torch.gather(labels.reshape(n, h * w).float(), 1, yi * w + xi)


def pointrend_loss(point_logits, point_coords, labels):
    """point_logits (N, P, C); point_coords (N, P, 2) in [0, 1] as
    (x, y); labels (N, H, W)."""
    point_labels = point_sample_nearest(labels, point_coords)
    point_logits = point_logits.float()
    if point_logits.shape[-1] == 1:
        return F.binary_cross_entropy_with_logits(
            point_logits[..., 0], point_labels)
    return F.cross_entropy(point_logits.transpose(1, 2),
                           point_labels.long())


class PanopticLoss:
    """Weighted semantic + center + offset (+ PointRend) loss. ``output``
    is the model's train-mode dict; ``target`` holds ``sem`` (N, H, W),
    ``ctr_hmp`` (N, 1, H, W) and ``offsets`` (N, 2, H, W). Returns
    (total, aux) with tensor values."""

    def __init__(self, ce_weight=1.0, mse_weight=200.0, l1_weight=0.01,
                 pr_weight=1.0, top_k_percent=0.2, **kwargs):
        self.ce_weight = ce_weight
        self.mse_weight = mse_weight
        self.l1_weight = l1_weight
        self.pr_weight = pr_weight
        self.top_k_percent = top_k_percent

    def __call__(self, output, target):
        mse = heatmap_mse(output["ctr_hmp"], target["ctr_hmp"])
        ce = bootstrap_ce(output["sem_logits"], target["sem"],
                          self.top_k_percent)
        offset_weights = (target["sem"] > 0)[:, None].float()
        l1 = offset_l1(output["offsets"], target["offsets"], offset_weights)

        aux = {"ce": ce, "l1": l1, "mse": mse}
        total = self.ce_weight * ce + self.mse_weight * mse \
            + self.l1_weight * l1
        if "sem_points" in output:
            pr_ce = pointrend_loss(output["sem_points"],
                                   output["point_coords"], target["sem"])
            aux["pointrend_ce"] = pr_ce
            total = total + self.pr_weight * pr_ce
        aux["total_loss"] = total
        return total, aux


class BCLoss:
    """The boundary-contour composite loss waits for the BC family."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "BCLoss is not ported yet: it comes with the boundary-contour "
            "(BC) model family")


LOSSES = {"PanopticLoss": PanopticLoss, "BCLoss": BCLoss}


def create_loss(name, **kwargs):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; choices: {sorted(LOSSES)}")
    return LOSSES[name](**kwargs)
