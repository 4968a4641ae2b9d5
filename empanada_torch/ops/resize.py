"""Bilinear resizing with explicit align_corners semantics and factor padding.

NCHW (or HW) tensors. The arithmetic follows the JAX package's
gather + lerp form exactly — rows first, then columns, source
coordinates clipped to the grid — so results agree to float rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear", "interpolate_scale", "factor_pad"]


def _axis_coords(out_size: int, in_size: int, align_corners: bool, device):
    """Source (float) coordinates for each output index along one axis."""
    idx = torch.arange(out_size, dtype=torch.float32, device=device)
    if align_corners and out_size > 1:
        coords = idx * np.float32((in_size - 1) / (out_size - 1))
    else:
        coords = (idx + 0.5) * np.float32(in_size / out_size) - 0.5
    return coords.clamp(0.0, in_size - 1)


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = True):
    """Resize an NCHW (or HW) tensor to spatial ``size`` = (H', W')."""
    orig_ndim = x.ndim
    if x.ndim == 2:
        x = x[None, None]
    n, c, h, w = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        out = x
    else:
        dtype = x.dtype
        xf = x.float()
        ys = _axis_coords(oh, h, align_corners, x.device)
        xs = _axis_coords(ow, w, align_corners, x.device)
        y0 = ys.floor().long()
        x0 = xs.floor().long()
        y1 = (y0 + 1).clamp(max=h - 1)
        x1 = (x0 + 1).clamp(max=w - 1)
        wy = (ys - y0)[None, None, :, None]
        wx = (xs - x0)[None, None, None, :]
        rows = xf[:, :, y0, :] * (1 - wy) + xf[:, :, y1, :] * wy
        out = rows[:, :, :, x0] * (1 - wx) + rows[:, :, :, x1] * wx
        out = out.to(dtype)
    if orig_ndim == 2:
        return out[0, 0]
    return out


def interpolate_scale(x: torch.Tensor, scale: int, align_corners: bool = True):
    """Upsample NCHW by an integer scale factor."""
    h, w = x.shape[-2], x.shape[-1]
    return resize_bilinear(x, (h * scale, w * scale), align_corners)


def factor_pad(x, factor: int = 128):
    """Zero-pad the last two (spatial) dims up to a multiple of ``factor``.

    Returns (padded, (orig_h, orig_w)). A numpy input stays numpy, so
    host batches are padded on the host before their one upload.
    """
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % factor
    pw = (-w) % factor
    if ph == 0 and pw == 0:
        return x, (h, w)
    if isinstance(x, np.ndarray):
        pad = [(0, 0)] * (x.ndim - 2) + [(0, ph), (0, pw)]
        return np.pad(x, pad), (h, w)
    return F.pad(x, (0, pw, 0, ph)), (h, w)
