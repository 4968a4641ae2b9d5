"""PointRend semantic-segmentation refinement (NCHW).

Eval: ``subdivision_steps`` rounds of: 2x upsample the logits, pick the
K most uncertain grid points with an EXACT top-k whose ties go to the
lower flat index (as ``lax.top_k``), re-predict them with a shared
pointwise MLP over sampled decoder features + coarse logits, and write
them back.

Train: importance-sample ``train_num_points`` points per image (random
points, the most uncertain of an oversampled set plus uniform ones),
drawn from an explicit ``torch.Generator``, and predict them with the
same MLP. The caller may pass the coordinates instead (the parity tests
feed the JAX package's draw). Under data parallelism the generator is a
``GlobalDraw``: every rank draws the global batch's random numbers and
keeps its own rows, so the ranks train on the points one process would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from empanada_torch.models.blocks import Linear
from empanada_torch.ops.resize import interpolate_scale
from empanada_torch.ops.sampling import point_sample, point_sample_full_grid

__all__ = [
    "GlobalDraw",
    "calculate_uncertainty",
    "topk_lower_index",
    "get_uncertain_point_coords_on_grid",
    "get_uncertain_point_coords_with_randomness",
    "StandardPointHead",
    "PointRendSemSegHead",
]


class GlobalDraw:
    """A ``torch.Generator`` seen by rank ``rank`` of ``world`` equal
    shares of a global batch."""

    def __init__(self, generator, world, rank):
        self.generator, self.world, self.rank = generator, world, rank


def _rand(n, rest, generator, device):
    """(n, *rest) uniform draws; with a ``GlobalDraw``, this rank's rows
    of the global batch's (n * world, *rest) draw."""
    if isinstance(generator, GlobalDraw):
        full = torch.rand((n * generator.world,) + rest,
                          generator=generator.generator, device=device)
        return full[generator.rank * n:(generator.rank + 1) * n]
    return torch.rand((n,) + rest, generator=generator, device=device)


def calculate_uncertainty(logits: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) logits -> (N, 1, H, W) uncertainty scores."""
    if logits.shape[1] == 1:
        return -torch.abs(logits)
    top2 = torch.topk(logits, 2, dim=1).values
    return (top2[:, 1] - top2[:, 0])[:, None]


def topk_lower_index(scores: torch.Tensor, k: int):
    """Exact top-k over the last dim, descending, ties broken toward the
    lower index (``lax.top_k``'s order): a stable descending sort."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def get_uncertain_point_coords_on_grid(uncertainty_map, num_points: int):
    """Top-K uncertain grid points of an (N, 1, H, W) map. Returns
    (indices (N, K), coords (N, K, 2) as (x, y) in [0, 1])."""
    n, _, h, w = uncertainty_map.shape
    k = min(h * w, num_points)
    _, point_indices = topk_lower_index(uncertainty_map.reshape(n, h * w), k)
    xs = (point_indices % w).float()
    ys = (point_indices // w).float()
    coords = torch.stack([0.5 / w + xs / w, 0.5 / h + ys / h], dim=-1)
    return point_indices, coords


def get_uncertain_point_coords_with_randomness(
        coarse_logits, num_points: int, oversample_ratio: int,
        importance_sample_ratio: float, generator=None):
    """Train-time point sampling from (N, C, H, W) logits. Returns
    (N, num_points, 2) coords in [0, 1]^2 as (x, y); no gradient."""
    n = coarse_logits.shape[0]
    dev = coarse_logits.device
    num_sampled = int(num_points * oversample_ratio)
    with torch.no_grad():
        coords = _rand(n, (num_sampled, 2), generator, dev)
        point_logits = point_sample(coarse_logits.detach().float(), coords)
        if point_logits.shape[-1] == 1:
            uncertainty = -point_logits[..., 0].abs()
        else:
            top2 = torch.topk(point_logits, 2, dim=-1).values
            uncertainty = top2[..., 1] - top2[..., 0]
        num_uncertain = int(importance_sample_ratio * num_points)
        idx = torch.topk(uncertainty, num_uncertain, dim=1).indices
        picked = torch.gather(coords, 1, idx[..., None].expand(-1, -1, 2))
        num_random = num_points - num_uncertain
        if num_random > 0:
            picked = torch.cat(
                [picked, _rand(n, (num_random, 2), generator, dev)], 1)
    return picked


class StandardPointHead(nn.Module):
    """Shared pointwise MLP over sampled features + coarse logits.
    Inputs/outputs are (N, P, C); ``Dense_i`` are flax's Dense layers."""

    def __init__(self, num_classes, fc_dim, num_fc=3,
                 coarse_pred_each_layer=True):
        super().__init__()
        self.num_fc = num_fc
        self.coarse_pred_each_layer = coarse_pred_each_layer
        nin = fc_dim + num_classes
        for i in range(num_fc):
            self.add_module(f"Dense_{i}", Linear(nin, fc_dim))
            nin = fc_dim + (num_classes if coarse_pred_each_layer else 0)
        self.add_module(f"Dense_{num_fc}", Linear(nin, num_classes))

    def forward(self, fine_features, coarse_logits):
        x = torch.cat([fine_features, coarse_logits], dim=-1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse_logits], dim=-1)
        return getattr(self, f"Dense_{self.num_fc}")(x)


class PointRendSemSegHead(nn.Module):
    def __init__(self, num_classes, fc_dim, num_fc=3, subdivision_steps=2,
                 subdivision_num_points=8192, train_num_points=1024,
                 oversample_ratio=3, importance_sample_ratio=0.75):
        super().__init__()
        self.train_num_points = train_num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.StandardPointHead_0 = StandardPointHead(num_classes, fc_dim,
                                                     num_fc)

    def forward_train(self, coarse_logits, features, point_coords=None,
                      generator=None):
        """Train branch: {"sem_seg_logits": the coarse logits,
        "point_logits": (N, P, C), "point_coords": (N, P, 2)}. Draws the
        points from ``generator`` unless ``point_coords`` is given."""
        if point_coords is None:
            point_coords = get_uncertain_point_coords_with_randomness(
                coarse_logits, self.train_num_points, self.oversample_ratio,
                self.importance_sample_ratio, generator)
        coarse_pts = point_sample(coarse_logits, point_coords)
        fine_pts = point_sample(features, point_coords)
        return {"sem_seg_logits": coarse_logits,
                "point_logits": self.StandardPointHead_0(fine_pts,
                                                         coarse_pts),
                "point_coords": point_coords}

    def forward(self, coarse_logits, features, render_steps=None):
        """coarse_logits: (N, C, H/4, W/4); features: decoder features at
        the same resolution. Returns {"sem_seg_logits": (N, C, H', W')}."""
        steps = self.subdivision_steps if render_steps is None \
            else render_steps
        logits = coarse_logits
        for step in range(steps):
            logits = interpolate_scale(logits, 2, align_corners=False)
            idx, coords = get_uncertain_point_coords_on_grid(
                calculate_uncertainty(logits), self.subdivision_num_points)
            # the coords are exactly this step's output-grid points, so
            # the coarse side samples the dense grid lerp at idx
            dense = point_sample_full_grid(coarse_logits, 2 ** (step + 1))
            nb, cc, hh, ww = dense.shape
            coarse_pts = torch.gather(
                dense.reshape(nb, cc, hh * ww), 2,
                idx[:, None, :].expand(nb, cc, -1)).transpose(1, 2)
            fine_pts = point_sample(features, coords)
            point_logits = self.StandardPointHead_0(fine_pts, coarse_pts)

            n, c, h, w = logits.shape
            flat = logits.reshape(n, c, h * w).clone()
            flat.scatter_(2, idx[:, None, :].expand(n, c, -1),
                          point_logits.transpose(1, 2).to(flat.dtype))
            logits = flat.reshape(n, c, h, w)
        return {"sem_seg_logits": logits}
