"""Point sampling of NCHW feature maps at normalized coordinates.

grid_sample(align_corners=False, padding_mode="zeros") semantics:
coords live in [0, 1]^2 as (x, y), source pixel position is
coord * size - 0.5, and corners outside the grid contribute zero. The
arithmetic (x-lerp, then y-lerp, in float32) matches the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["point_sample", "point_sample_full_grid"]


def point_sample_full_grid(features: torch.Tensor, scale: int) -> torch.Tensor:
    """``point_sample`` evaluated at EVERY point of the upsampled-by-
    ``scale`` output grid: output pixel (i, j) samples the source at
    ((j + 0.5)/scale - 0.5, (i + 0.5)/scale - 0.5). Each output phase
    p in [0, scale) has a constant source offset and lerp weight, so
    the map is built from shifts and lerps. (N, C, H, W) ->
    (N, C, H*scale, W*scale)."""

    def lerp_axis(x, dim):
        size = x.shape[dim]
        parts = []
        for p in range(scale):
            src = (p + 0.5) / scale - 0.5
            lo = math.floor(src)
            t = torch.tensor(src - lo, dtype=torch.float32)

            def shifted(d):
                if d == 0:
                    return x
                pad = [0, 0] * (x.ndim - dim)
                # F.pad lists pads from the last dim backwards
                slot = 2 * (x.ndim - 1 - dim)
                if d < 0:  # index k-1: zero-pad front, drop tail
                    pad[slot] = -d
                    return F.pad(x, pad).narrow(dim, 0, size)
                pad[slot + 1] = d  # index k+1: drop head, zero-pad back
                return F.pad(x, pad).narrow(dim, d, size)

            v0 = shifted(lo)
            v1 = shifted(lo + 1)
            parts.append(v0 * (1 - t) + v1 * t)
        stacked = torch.stack(parts, dim=dim + 1)
        shape = list(x.shape)
        shape[dim] = size * scale
        return stacked.reshape(shape)

    x = features.float()
    x = lerp_axis(x, 3)  # x-lerp first (point_sample order)
    return lerp_axis(x, 2)


def point_sample(features: torch.Tensor, point_coords: torch.Tensor):
    """Sample (N, C, H, W) features at (N, P, 2) coords given as (x, y)
    in [0, 1]. Returns (N, P, C)."""
    n, c, h, w = features.shape
    x = point_coords[..., 0] * w - 0.5
    y = point_coords[..., 1] * h - 0.5
    flat = features.reshape(n, c, h * w)

    def gather(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        vals = torch.gather(flat, 2, idx[:, None, :].expand(n, c, -1))
        return torch.where(inside[..., None], vals.transpose(1, 2), 0.0)

    xf = torch.floor(x)
    yf = torch.floor(y)
    x0 = xf.long()
    y0 = yf.long()
    wx = (x - xf)[..., None]
    wy = (y - yf)[..., None]
    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy
