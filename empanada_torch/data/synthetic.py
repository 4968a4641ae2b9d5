"""Synthetic EM-like volumes with instance ground truth.

The JAX package's ``data/synthetic.py``, byte for byte: the same
``np.random.default_rng(seed)`` draws in the same order, so both
packages make the same volume from a seed. Not to be confused with
``empanada_torch.synthetic``, the parameter-free model twin.

Creates content with realistic
per-slice instance density (tens to hundreds of blobby organelle
cross-sections per plane, like the mitochondria volumes the reference's
MitoNet targets — reference scripts/pdl_inference3d.py operates at
label_divisor 20000 with hundreds of instances per slice).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_em_volume"]


def synthetic_em_volume(shape, n_instances=40, seed=0, radius=(8, 40),
                        contrast=0.3, noise=0.1, mean=0.5,
                        overlap=True):
    """Dark ellipsoid instances on a noisy background.

    Returns (volume uint8 (D, H, W), gt uint32 instance labels). With
    ``overlap=True`` (the default)
    later instances overwrite earlier ones where they overlap; at low
    densities labels stay connected per id in practice.

    ``overlap=False`` places each ellipsoid in its own jittered grid
    cell so instances are DISJOINT — required for product-scale content
    (512^3-1k^3 with thousands of instances): at those densities the
    legacy overwrite carves objects into nested fragments that no
    instance pipeline (this one or the reference's — both heal false
    splits by IoA, reference matcher.py:234-326) can keep apart, which
    says nothing about real EM where organelles are disjoint.

    Each ellipsoid is evaluated only inside its bounding box (identical
    output to a full-volume test, since the inside-test is local), so
    product-scale volumes (512^3-1k^3 with thousands of instances) are
    generated in seconds instead of hours.
    """
    rng = np.random.default_rng(seed)
    D, H, W = shape
    vol = rng.normal(mean, noise, shape).astype(np.float32)
    gt = np.zeros(shape, np.uint32)
    if overlap:
        placements = _overlapping_placements(rng, shape, n_instances,
                                             radius)
    else:
        placements = _grid_placements(rng, shape, n_instances, radius)
    for i, (c, r) in enumerate(placements):
        lo = [max(int(np.floor(c[j] - r[j])), 0) for j in range(3)]
        hi = [min(int(np.ceil(c[j] + r[j])) + 1, shape[j]) for j in range(3)]
        # float64 with the exact legacy formula so the inside-test is
        # bit-identical to the old full-volume mgrid version
        zz = ((np.arange(lo[0], hi[0], dtype=np.float64)
               - c[0]) ** 2 / r[0] ** 2)[:, None, None]
        yy = ((np.arange(lo[1], hi[1], dtype=np.float64)
               - c[1]) ** 2 / r[1] ** 2)[None, :, None]
        xx = ((np.arange(lo[2], hi[2], dtype=np.float64)
               - c[2]) ** 2 / r[2] ** 2)[None, None, :]
        ball = zz + yy + xx <= 1.0
        sub = (slice(lo[0], hi[0]), slice(lo[1], hi[1]), slice(lo[2], hi[2]))
        vol[sub][ball] -= contrast
        gt[sub][ball] = i + 1
    return (vol.clip(0, 1) * 255).astype(np.uint8), gt


def _overlapping_placements(rng, shape, n_instances, radius):
    """Legacy unconstrained centers (draw order matches old inline loop
    exactly: radii then center per instance)."""
    D = shape[0]
    out = []
    for _ in range(n_instances):
        r = rng.uniform(radius[0], radius[1], size=3)
        r[0] = min(r[0], D / 3)  # keep z extent inside shallow stacks
        c = [rng.uniform(r[j] * 0.5, s - r[j] * 0.5)
             for j, s in enumerate(shape)]
        out.append((c, r))
    return out


def _grid_placements(rng, shape, n_instances, radius):
    """One ellipsoid per jittered grid cell -> guaranteed disjoint.

    Grid dims scale with the volume's aspect so cells are roughly
    cubic; per-axis radii are capped at just under the half-cell so the
    ellipsoid (inside-test is strict) stays in its cell."""
    D, H, W = shape
    vol_per = D * H * W / n_instances
    cell = vol_per ** (1.0 / 3.0)
    dims = [max(int(np.ceil(s / cell)), 1) for s in shape]
    while dims[0] * dims[1] * dims[2] < n_instances:
        j = int(np.argmax([shape[k] / dims[k] for k in range(3)]))
        dims[j] += 1
    cells = [(z, y, x) for z in range(dims[0]) for y in range(dims[1])
             for x in range(dims[2])]
    order = rng.permutation(len(cells))[:n_instances]
    sizes = [shape[j] / dims[j] for j in range(3)]
    out = []
    for idx in order:
        cz, cy, cx = cells[idx]
        los = [cz * sizes[0], cy * sizes[1], cx * sizes[2]]
        # floor the radius at 0.9 px (> sqrt(3)/2, so the nearest integer
        # voxel is always strictly inside the ellipsoid and every placement
        # paints >=1 voxel — tiny cells used to draw negative/sub-voxel
        # radii and silently drop instances), and cap it under the
        # half-cell so adjacent cells' balls stay disjoint
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
            # margin can invert when the ball nearly fills the cell:
            # pin the center mid-cell instead of sampling a reversed range
            c.append(rng.uniform(lo_c, hi_c) if hi_c > lo_c
                     else los[j] + sizes[j] / 2)
        out.append((c, r))
    return out
