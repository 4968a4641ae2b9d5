"""Training losses (NCHW model outputs).

The JAX package's ``losses.py`` in PyTorch:

- ``bootstrap_ce``: (binary) cross-entropy averaged over the top-k%% of
  the per-pixel losses of the whole batch, k = int(pct * size);
- ``heatmap_mse``: MSE on center heatmaps;
- ``offset_l1``: L1 on offsets over the GT foreground, summed over both
  channels and divided by the mask's sum (0 for an empty mask);
- ``pointrend_loss``: CE between point logits and the GT sampled at the
  PointRend coordinates (nearest);
- ``PanopticLoss``: the weighted composite returning (total, aux);
- ``BCLoss``: the boundary-contour composite (semantic + contour).

C = 1 uses sigmoid BCE, C > 1 softmax CE. The losses run in float32
whatever the dtype of the model's outputs.

Data-parallel training (``gb``, a ``GlobalBatch``) computes each loss
over the GLOBAL batch, as the JAX package's step over its mesh does:
bootstrap_ce takes the top k of all ranks' pixels, offset_l1 divides by
the global weight sum, the means run over the global batch. Each rank's
loss then has the global value, and a gradient scaled so that the mean
of the ranks' gradients (``DistributedDataParallel``) is the global
loss's gradient. Without ``gb`` each function is the one-process loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "GlobalBatch",
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


class GlobalBatch:
    """The ranks of the default process group in a data-parallel step,
    each holding an equal share of the global batch."""

    def __init__(self):
        import torch.distributed as dist

        self.world = dist.get_world_size()
        self.rank = dist.get_rank()

    def sum(self, t):
        """The sum over ranks of ``t`` (no gradient)."""
        import torch.distributed as dist

        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    def gather(self, t):
        """``t`` of every rank, by rank (no gradient)."""
        import torch.distributed as dist

        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.detach().contiguous())
        return out

    def share(self, part):
        """A rank's ``part`` of a loss that is the sum over ranks of the
        parts: the value is that sum, the gradient ``world`` times the
        part's, so that DDP's mean of the ranks' gradients is the sum's
        gradient."""
        scaled = part * self.world
        return scaled + (self.sum(part) - scaled).detach()


def _global_mean(mean, gb):
    """A rank's mean over its share as the global batch's mean."""
    return mean if gb is None else gb.share(mean / gb.world)


def _pixel_ce(logits, labels):
    """Per-pixel (binary) cross-entropy. logits (N, C, H, W); labels
    (N, H, W)."""
    logits = logits.float()
    if logits.shape[1] == 1:
        return F.binary_cross_entropy_with_logits(
            logits[:, 0], labels.float(), reduction="none")
    return F.cross_entropy(logits, labels.long(), reduction="none")


def bootstrap_ce(logits, labels, top_k_percent_pixels=0.2, gb=None):
    """logits (N, C, H, W); labels (N, H, W)."""
    pixel_losses = _pixel_ce(logits, labels).reshape(-1)
    if top_k_percent_pixels >= 1.0:
        return _global_mean(pixel_losses.mean(), gb)
    if gb is None:
        k = max(1, int(top_k_percent_pixels * pixel_losses.numel()))
        return torch.topk(pixel_losses, k, sorted=False).values.mean()
    return gb.share(_global_top_k_sum(pixel_losses, top_k_percent_pixels,
                                      gb))


def _global_top_k_sum(pixel_losses, pct, gb):
    """This rank's part of the mean of the global top k, k = int(pct *
    global pixels): its pixels above the global k-th largest value t,
    and of the pixels equal to t those that ``lax.top_k`` over the
    ranks' concatenation would take (the lowest global indices first),
    summed and divided by k."""
    per_rank = gb.gather(pixel_losses)
    everything = torch.cat(per_rank)
    k = max(1, int(pct * everything.numel()))
    t = torch.topk(everything, k, sorted=False).values.min()
    above = torch.stack([(r > t).sum() for r in per_rank])
    ties = torch.stack([(r == t).sum() for r in per_rank])
    left = k - above.sum()  # tied pixels the top k still takes
    before = torch.cumsum(ties, 0)[gb.rank] - ties[gb.rank]
    mine = torch.clamp(left - before, min=0)
    tied = pixel_losses == t
    take = (pixel_losses > t) | (tied & (torch.cumsum(tied, 0) <= mine))
    return torch.where(take, pixel_losses,
                       torch.zeros_like(pixel_losses)).sum() / k


def heatmap_mse(output, target, gb=None):
    return _global_mean(torch.mean(torch.square(output.float() - target)),
                        gb)


def offset_l1(output, target, offset_weights, gb=None):
    """output, target (N, 2, H, W); offset_weights (N, 1, H, W)."""
    l1 = torch.abs(output.float() - target) * offset_weights
    weight_sum = offset_weights.sum()
    if gb is not None:
        weight_sum = gb.sum(weight_sum)
    loss = torch.where(weight_sum == 0, torch.zeros_like(weight_sum),
                       l1.sum() / torch.clamp(weight_sum, min=1))
    return loss if gb is None else gb.share(loss)


def point_sample_nearest(labels, point_coords):
    """(N, H, W) labels at (N, P, 2) coords (x, y) in [0, 1], nearest
    (round half to even, clipped to the grid). Returns (N, P) float."""
    n, h, w = labels.shape
    x = point_coords[..., 0] * w - 0.5
    y = point_coords[..., 1] * h - 0.5
    xi = torch.round(x).long().clamp(0, w - 1)
    yi = torch.round(y).long().clamp(0, h - 1)
    return torch.gather(labels.reshape(n, h * w).float(), 1, yi * w + xi)


def pointrend_loss(point_logits, point_coords, labels, gb=None):
    """point_logits (N, P, C); point_coords (N, P, 2) in [0, 1] as
    (x, y); labels (N, H, W)."""
    point_labels = point_sample_nearest(labels, point_coords)
    point_logits = point_logits.float()
    if point_logits.shape[-1] == 1:
        mean = F.binary_cross_entropy_with_logits(
            point_logits[..., 0], point_labels)
    else:
        mean = F.cross_entropy(point_logits.transpose(1, 2),
                               point_labels.long())
    return _global_mean(mean, gb)


class PanopticLoss:
    """Weighted semantic + center + offset (+ PointRend) loss. ``output``
    is the model's train-mode dict; ``target`` holds ``sem`` (N, H, W),
    ``ctr_hmp`` (N, 1, H, W) and ``offsets`` (N, 2, H, W). Returns
    (total, aux) with tensor values. ``global_batch`` (a
    ``GlobalBatch``, set by the trainer) makes every term global."""

    global_batch = None

    def __init__(self, ce_weight=1.0, mse_weight=200.0, l1_weight=0.01,
                 pr_weight=1.0, top_k_percent=0.2, **kwargs):
        self.ce_weight = ce_weight
        self.mse_weight = mse_weight
        self.l1_weight = l1_weight
        self.pr_weight = pr_weight
        self.top_k_percent = top_k_percent

    def __call__(self, output, target):
        gb = self.global_batch
        mse = heatmap_mse(output["ctr_hmp"], target["ctr_hmp"], gb)
        ce = bootstrap_ce(output["sem_logits"], target["sem"],
                          self.top_k_percent, gb)
        offset_weights = (target["sem"] > 0)[:, None].float()
        l1 = offset_l1(output["offsets"], target["offsets"], offset_weights,
                       gb)

        aux = {"ce": ce, "l1": l1, "mse": mse}
        total = self.ce_weight * ce + self.mse_weight * mse \
            + self.l1_weight * l1
        if "sem_points" in output:
            pr_ce = pointrend_loss(output["sem_points"],
                                   output["point_coords"], target["sem"], gb)
            aux["pointrend_ce"] = pr_ce
            total = total + self.pr_weight * pr_ce
        aux["total_loss"] = total
        return total, aux


class BCLoss:
    """Boundary-contour loss: bootstrapped CE on the semantic and the
    contour logits, plus PointRend CE on both where the model emitted
    points. ``target`` holds ``sem`` and ``cnt`` (N, H, W). Returns
    (total, aux). ``global_batch``: as ``PanopticLoss``'s."""

    global_batch = None

    def __init__(self, pr_weight=1.0, top_k_percent=0.15, **kwargs):
        self.pr_weight = pr_weight
        self.top_k_percent = top_k_percent

    def __call__(self, output, target):
        gb = self.global_batch
        sem_ce = bootstrap_ce(output["sem_logits"], target["sem"],
                              self.top_k_percent, gb)
        cnt_ce = bootstrap_ce(output["cnt_logits"], target["cnt"],
                              self.top_k_percent, gb)
        aux = {"sem_ce": sem_ce, "cnt_ce": cnt_ce}
        total = sem_ce + cnt_ce
        if "sem_points" in output:
            sem_pr = pointrend_loss(output["sem_points"],
                                    output["sem_point_coords"], target["sem"],
                                    gb)
            cnt_pr = pointrend_loss(output["cnt_points"],
                                    output["cnt_point_coords"], target["cnt"],
                                    gb)
            aux["sem_pr_ce"] = sem_pr
            aux["cnt_pr_ce"] = cnt_pr
            total = total + self.pr_weight * (sem_pr + cnt_pr)
        aux["total_loss"] = total
        return total, aux


LOSSES = {"PanopticLoss": PanopticLoss, "BCLoss": BCLoss}


def create_loss(name, **kwargs):
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; choices: {sorted(LOSSES)}")
    return LOSSES[name](**kwargs)
