"""Traffic generators: one general generator per kind of traffic, driven
by the parameters of a traffic file (``portbench/traffic/<name>.json``).

``training_pool``: EM-like crops with instance masks, made on the device
from the seed, and their Panoptic-DeepLab targets. An image is noise
around a background level with rotated ellipses (bright inside, a dark
membrane at the rim; a later ellipse covers an earlier one), as the
port's smoke set draws them; the targets are the semantic mask, the
center heatmap (a Gaussian at each instance's centroid, rounded down to
a pixel, of the given sigma, truncated at 4 sigma and scaled to a
maximum of 1) and the offsets (dy, dx) from each foreground pixel to its
instance's centroid.
"""

from __future__ import annotations

import math

import torch

__all__ = ["training_pool", "TrainingPool", "sub_seed"]


def sub_seed(seed, stream):
    """A 63-bit seed for the named stream of run seed ``seed``."""
    h = int(seed) * 0x9E3779B97F4A7C15 + sum(
        (i + 1) * 131 ** i * ord(c) for i, c in enumerate(stream))
    return h % (1 << 63)


class TrainingPool:
    """Batches in the program's collated layout (NHWC float32 on the
    host, pinned where the device is a card) and their PointRend points
    on the device."""

    def __init__(self, batches, coords):
        self.batches, self.coords = batches, coords

    def __len__(self):
        return len(self.batches)

    def nchw(self, i, device):
        """Batch ``i`` as NCHW device tensors (the reference's layout)."""
        b = self.batches[i]
        out = {"sem": b["sem"].to(device).float()}
        for key in ("image", "ctr_hmp", "offsets"):
            out[key] = b[key].to(device).permute(0, 3, 1, 2).contiguous()
        return out


def _gaussian_1d(sigma, device):
    ksize = int(round(sigma * 8 + 1)) | 1
    x = torch.arange(ksize, dtype=torch.float64, device=device) \
        - (ksize - 1) / 2
    k = torch.exp(-0.5 * x * x / (sigma * sigma))
    return (k / k.sum()).float(), ksize // 2


def _images(p, n, gen, device, norms):
    """(image, label) of ``n`` crops: image (n, S, S) normalized float32,
    label (n, S, S) int64 with 0 for the background."""
    s, kmax = p["crop"], p["instances"][1]
    img = p["image"]

    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    count = torch.randint(p["instances"][0], kmax + 1, (n, 1),
                          generator=gen, device=device)
    cy, cx = u(0, s, (n, kmax)), u(0, s, (n, kmax))
    a, b = u(*p["a"], (n, kmax)), u(*p["b"], (n, kmax))
    t = u(0, math.pi, (n, kmax))
    yy = torch.arange(s, device=device, dtype=torch.float32)
    dy = yy[None, None, :, None] - cy[..., None, None]
    dx = yy[None, None, None, :] - cx[..., None, None]
    cos, sin = torch.cos(t)[..., None, None], torch.sin(t)[..., None, None]
    r = ((dy * cos + dx * sin) / a[..., None, None]) ** 2 \
        + ((-dy * sin + dx * cos) / b[..., None, None]) ** 2
    valid = torch.arange(kmax, device=device)[None] < count
    inside = (r <= 1) & valid[..., None, None]
    ids = torch.arange(1, kmax + 1, device=device)[None, :, None, None]
    label = (inside * ids).amax(1)
    rim = torch.gather(r, 1, (label - 1).clamp(min=0)[:, None])[:, 0]
    bg_mean, bg_std = img["background"]
    in_mean, in_std = img["inside"]
    noise = torch.randn((2, n, s, s), generator=gen, device=device)
    value = bg_mean + bg_std * noise[0]
    value = torch.where(label > 0, in_mean + in_std * noise[1], value)
    value = torch.where((label > 0) & (rim > img["membrane_r"]),
                        torch.full_like(value, img["membrane"]), value)
    value = value.clamp(0, 255).floor()
    image = (value / 255.0 - norms["mean"]) / norms["std"]
    return image, label


def _targets(label, sigma, kmax):
    """(sem, heatmap, offsets) of an (n, S, S) label map."""
    n, s, _ = label.shape
    device = label.device
    yy = torch.arange(s, device=device, dtype=torch.float32)
    flat = (label + torch.arange(n, device=device)[:, None, None]
            * (kmax + 1)).reshape(-1)
    size = n * (kmax + 1)
    ys = yy[None, :, None].expand(n, s, s).reshape(-1)
    xs = yy[None, None, :].expand(n, s, s).reshape(-1)
    ones = torch.ones_like(ys, dtype=torch.float64)
    cnt = torch.zeros(size, dtype=torch.float64, device=device) \
        .index_add_(0, flat, ones)
    ysum = torch.zeros_like(cnt).index_add_(0, flat, ys.double())
    xsum = torch.zeros_like(cnt).index_add_(0, flat, xs.double())
    present = (cnt > 0).reshape(n, kmax + 1)
    present[:, 0] = False
    cy = (ysum / cnt.clamp(min=1)).float().reshape(n, kmax + 1)
    cx = (xsum / cnt.clamp(min=1)).float().reshape(n, kmax + 1)
    kernel, half = _gaussian_1d(sigma, device)

    def profile(c):
        d = yy[None, None, :] - c.floor()[..., None] + half
        inside = (d >= 0) & (d <= 2 * half)
        return torch.where(inside, kernel[d.clamp(0, 2 * half).long()], 0.0)

    gy = profile(cy) * present[..., None]
    heat = torch.einsum("nkh,nkw->nhw", gy, profile(cx))
    peak = heat.amax((1, 2), keepdim=True)
    heat = torch.where(peak > 0, heat / peak.clamp(min=1e-30), heat)
    lab_cy = torch.gather(cy, 1, label.reshape(n, -1)).reshape(n, s, s)
    lab_cx = torch.gather(cx, 1, label.reshape(n, -1)).reshape(n, s, s)
    fg = label > 0
    off = torch.stack([torch.where(fg, lab_cy - yy[None, :, None], 0.0),
                       torch.where(fg, lab_cx - yy[None, None, :], 0.0)], -1)
    return fg.float(), heat, off


def training_pool(p, norms, seed, device):
    """``p["pool"]`` batches of ``p["batch"]`` crops of ``p["crop"]``^2
    (every image distinct) with ``p["points"]`` uniform PointRend points
    an image, from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(sub_seed(seed, "pool"))
    pin = device.type == "cuda"
    batches, coords = [], []
    for _ in range(p["pool"]):
        image, label = _images(p, p["batch"], gen, device, norms)
        sem, heat, off = _targets(label, p["heatmap_sigma"],
                                  p["instances"][1])
        batch = {"image": image[..., None], "sem": sem,
                 "ctr_hmp": heat[..., None], "offsets": off}
        batches.append({k: (v.cpu().pin_memory() if pin else v.clone())
                        for k, v in batch.items()})
        coords.append(torch.rand((p["batch"], p["points"], 2),
                                 generator=gen, device=device))
    return TrainingPool(batches, coords)


# --- volumes (inference cells) ---------------------------------------------

def em_volume(p, seed):
    """Dark ellipsoids on a noisy background, as the port's synthetic EM
    volumes draw them: ``p["shape"]`` (D, H, W), ``p["instances"]``
    ellipsoids of radii in ``p["radius"]``, disjoint (one to a jittered
    grid cell) unless ``p["overlap"]``. Returns (uint8 volume, uint32
    ground truth)."""
    import numpy as np

    shape = tuple(p["shape"])
    radius = tuple(p.get("radius", (8, 40)))
    rng = np.random.default_rng(int(seed))
    vol = rng.normal(p.get("mean", 0.5), p.get("noise", 0.1),
                     shape).astype(np.float32)
    gt = np.zeros(shape, np.uint32)
    place = _overlapping if p.get("overlap", True) else _grid
    for i, (c, r) in enumerate(place(rng, shape, p["instances"], radius)):
        lo = [max(int(np.floor(c[j] - r[j])), 0) for j in range(3)]
        hi = [min(int(np.ceil(c[j] + r[j])) + 1, shape[j]) for j in range(3)]
        zz = ((np.arange(lo[0], hi[0], dtype=np.float64) - c[0]) ** 2
              / r[0] ** 2)[:, None, None]
        yy = ((np.arange(lo[1], hi[1], dtype=np.float64) - c[1]) ** 2
              / r[1] ** 2)[None, :, None]
        xx = ((np.arange(lo[2], hi[2], dtype=np.float64) - c[2]) ** 2
              / r[2] ** 2)[None, None, :]
        ball = zz + yy + xx <= 1.0
        sub = tuple(slice(a, b) for a, b in zip(lo, hi))
        vol[sub][ball] -= p.get("contrast", 0.3)
        gt[sub][ball] = i + 1
    return (vol.clip(0, 1) * 255).astype(np.uint8), gt


def _overlapping(rng, shape, n, radius):
    out = []
    for _ in range(n):
        r = rng.uniform(radius[0], radius[1], size=3)
        r[0] = min(r[0], shape[0] / 3)
        c = [rng.uniform(r[j] * 0.5, s - r[j] * 0.5)
             for j, s in enumerate(shape)]
        out.append((c, r))
    return out


def _grid(rng, shape, n, radius):
    """One ellipsoid to a jittered cell of a grid of about cubic cells,
    its radii under half the cell."""
    import numpy as np

    cell = (np.prod(shape) / n) ** (1.0 / 3.0)
    dims = [max(int(np.ceil(s / cell)), 1) for s in shape]
    while dims[0] * dims[1] * dims[2] < n:
        j = int(np.argmax([shape[k] / dims[k] for k in range(3)]))
        dims[j] += 1
    cells = [(z, y, x) for z in range(dims[0]) for y in range(dims[1])
             for x in range(dims[2])]
    order = rng.permutation(len(cells))[:n]
    sizes = [shape[j] / dims[j] for j in range(3)]
    out = []
    for idx in order:
        los = [cells[idx][j] * sizes[j] for j in range(3)]
        r = []
        for j in range(3):
            hi_r = min(max(min(radius[1], sizes[j] / 2 - 1.0), 0.95),
                       sizes[j] / 2 - 0.05)
            lo_r = min(max(min(radius[0], sizes[j] / 2 - 1.5), 0.9), hi_r)
            r.append(rng.uniform(lo_r, hi_r))
        c = []
        for j in range(3):
            lo_c = los[j] + r[j] + 0.5
            hi_c = los[j] + sizes[j] - r[j] - 0.5
            c.append(rng.uniform(lo_c, hi_c) if hi_c > lo_c
                     else los[j] + sizes[j] / 2)
        out.append((c, r))
    return out
