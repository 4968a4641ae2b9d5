"""Training targets: center heatmaps and offsets (numpy + scipy).

The JAX package's ``heatmap_and_offsets`` without OpenCV: centroids
from one bincount pass, then the Gaussian blur cv2.GaussianBlur gives a
float32 image at ``ksize=(0, 0)`` (kernel size round(8 sigma + 1) | 1,
cv2's kernel formula, zero border), as two separable passes; and the
boundary-contour family's contour target (``seg_to_instance_bd``),
with numpy reflect padding and scipy's binary dilation in place of
cv2's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["heatmap_and_offsets", "gaussian_kernel", "gaussian_blur",
           "seg_to_instance_bd"]


def gaussian_kernel(ksize, sigma):
    """cv2.getGaussianKernel(ksize, sigma) as float64: exp(-x^2 /
    (2 sigma^2)) at x = i - (ksize - 1) / 2, normalized to sum 1; with
    sigma <= 0, sigma = 0.3 ((ksize - 1) / 2 - 1) + 0.8, and cv2's fixed
    tables for ksize 1, 3, 5, 7."""
    small = {1: [1.0], 3: [0.25, 0.5, 0.25],
             5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]}
    if sigma <= 0 and ksize in small:
        return np.array(small[ksize])
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k / k.sum()


def gaussian_blur(image, kernel, mode):
    """Separable correlation of an (H, W[, C]) image with a 1D kernel
    along rows and columns, in float64; ``mode`` is scipy's border
    ("constant" = zero, "mirror" = cv2's BORDER_REFLECT_101)."""
    from scipy.ndimage import correlate1d

    out = correlate1d(np.asarray(image, np.float64), kernel, axis=0,
                      mode=mode, cval=0.0)
    return correlate1d(out, kernel, axis=1, mode=mode, cval=0.0)


def _label_centroids(sl2d):
    """(labels, cy, cx) for each nonzero label via one bincount pass."""
    labels = np.unique(sl2d)
    labels = labels[labels > 0]
    if len(labels) == 0:
        return labels, np.array([]), np.array([])
    h, w = sl2d.shape
    flat = sl2d.reshape(-1).astype(np.int64)
    size = int(flat.max()) + 1
    counts = np.bincount(flat, minlength=size)
    yy = np.repeat(np.arange(h, dtype=np.float64), w)
    xx = np.tile(np.arange(w, dtype=np.float64), h)
    ysum = np.bincount(flat, weights=yy, minlength=size)
    xsum = np.bincount(flat, weights=xx, minlength=size)
    return labels, ysum[labels] / counts[labels], xsum[labels] / counts[labels]


def heatmap_and_offsets(sl2d, heatmap_sigma=6):
    """Instance seg (H, W) -> (heatmap (H, W, 1), offsets (H, W, 2)):
    the Gaussian-blurred, max-normalized center heatmap, and per pixel
    the (dy, dx) to its instance's centroid, zero outside instances."""
    sl2d = np.asarray(sl2d)
    h, w = sl2d.shape
    heatmap = np.zeros((h, w), dtype=np.float32)
    labels, cy, cx = _label_centroids(sl2d)

    size = (int(sl2d.max()) + 1) if len(labels) else 1
    ctr_y = np.zeros((size,), np.float32)
    ctr_x = np.zeros((size,), np.float32)
    for lab, y, x in zip(labels, cy, cx):
        heatmap[int(y), int(x)] = 1
        ctr_y[lab] = y
        ctr_x[lab] = x

    if len(labels):
        ksize = int(np.rint(heatmap_sigma * 8 + 1)) | 1
        heatmap = gaussian_blur(
            heatmap, gaussian_kernel(ksize, heatmap_sigma),
            "constant").astype(np.float32)
        hmax = heatmap.max()
        if hmax > 0:
            heatmap = heatmap / hmax

    lab_map = sl2d.astype(np.int64).clip(0, size - 1)
    off_y = ctr_y[lab_map] - np.arange(h, dtype=np.float32)[:, None]
    off_x = ctr_x[lab_map] - np.arange(w, dtype=np.float32)[None, :]
    fg = sl2d > 0
    off_y[~fg] = 0
    off_x[~fg] = 0
    offsets = np.stack([off_y, off_x], axis=-1).astype(np.float32)
    return heatmap[..., None], offsets


def seg_to_instance_bd(seg, tsz_h=1):
    """Instance seg stack (D, H, W) -> binary contour map (D, H, W) uint8:
    1 where a pixel differs from a vertical or horizontal neighbour
    (edges reflect, cv2's BORDER_REFLECT: the border pixel repeats),
    dilated by a (2 tsz_h + 1)^2 square (cv2.dilate's zero border)."""
    from scipy.ndimage import binary_dilation

    seg = np.asarray(seg)
    tsz = tsz_h * 2 + 1
    structure = np.ones((tsz, tsz), bool)
    bd = np.zeros(seg.shape, np.uint8)
    for z in range(seg.shape[0]):
        padded = np.pad(seg[z], 1, mode="symmetric")
        edge = (padded[:-2, 1:-1] != padded[2:, 1:-1]) \
            | (padded[1:-1, :-2] != padded[1:-1, 2:])
        bd[z] = binary_dilation(edge, structure)
    return bd
