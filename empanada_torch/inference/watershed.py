"""Boundary-contour decoding: 3D watershed instance extraction.

- seeds: (semantic > thres1) & (boundary < thres2), 26-connected
  components (``core/ccl3d.py``, on the host), size-filtered;
- instances flood the foreground (semantic > thres3) from the seeds in
  order of descending semantic value: the uint8 values are taken level
  by level, and at each level labels spread through the voxels at or
  above it by rounds of whole-volume 6-neighbour shifts until a round
  changes nothing (a discrete priority flood; ties go to the largest
  neighbouring label, and a round reads only the labels of the round
  before, so the result is deterministic);
- labels under ``min_size`` voxels are dropped, the rest shifted by
  ``label_divisor``.

``bc_watershed`` runs the flood as torch ops on the device (an int32
label volume; a round is six zero-filled shifts, a max and a
``where``). A round that changes nothing is a fixed point, so extra
rounds are no-ops: at each level the device runs 1, then 2, 4, 8 and at
most 16 rounds between two checks of "did the last round change
anything" (one host sync per check) and gives exactly the labels of
the numpy flood, which checks after every round. ``bc_watershed_numpy``
and ``watershed_descending`` / ``mask_watershed`` are the JAX package's
numpy code, the plain version. ``mask_watershed`` is the
intensity-free variant (one level).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from empanada_torch.core.ccl3d import connected_components_3d, size_threshold_3d
from empanada_torch.device import resolve_device

__all__ = ["bc_watershed", "bc_watershed_numpy", "mask_watershed",
           "watershed_descending", "flood_levels", "cast2dtype"]

MAX_ROUNDS_PER_CHECK = 16


def cast2dtype(segm):
    """Smallest uint dtype that holds the max id."""
    mid = np.max(segm)
    m_type = np.uint64
    if mid < 2 ** 8:
        m_type = np.uint8
    elif mid < 2 ** 16:
        m_type = np.uint16
    elif mid < 2 ** 32:
        m_type = np.uint32
    return segm.astype(m_type)


# --- the plain version (numpy) ---------------------------------------------

def _propagate_once(labels, allowed):
    """One 6-neighborhood label-propagation round. Returns (labels,
    n_changed). Ties resolve to the max label (deterministic)."""
    prop = np.zeros_like(labels)
    for axis in (0, 1, 2):
        for shift in (1, -1):
            moved = np.roll(labels, shift, axis=axis)
            # zero the wrapped border
            sl = [slice(None)] * 3
            sl[axis] = 0 if shift == 1 else -1
            moved[tuple(sl)] = 0
            prop = np.maximum(prop, moved)
    fill = (labels == 0) & allowed & (prop > 0)
    if not fill.any():
        return labels, 0
    labels = np.where(fill, prop, labels)
    return labels, int(fill.sum())


def mask_watershed(mask, markers, connectivity=1):
    """BFS flood of a binary mask from markers: each round extends
    labels one voxel into the unlabeled mask."""
    labels = np.ascontiguousarray(markers).astype(np.int64)
    mask = np.ascontiguousarray(mask).astype(bool)
    while True:
        labels, changed = _propagate_once(labels, mask)
        if changed == 0:
            break
    return labels


def watershed_descending(intensity, markers, mask):
    """Discrete priority-flood: flood `mask` from `markers` in order of
    descending `intensity` (uint8-bucketed)."""
    intensity = np.ascontiguousarray(intensity)
    labels = np.ascontiguousarray(markers).astype(np.int64)
    mask = np.ascontiguousarray(mask).astype(bool)

    levels = np.unique(intensity[mask])[::-1]
    for lvl in levels:
        allowed = mask & (intensity >= lvl)
        while True:
            labels, changed = _propagate_once(labels, allowed)
            if changed == 0:
                break
    return labels


# --- the device flood (torch) ----------------------------------------------

def _flood(padded, allowed, stats):
    """Rounds of 6-neighbour propagation on ``padded`` (an int32 label
    volume with a one-voxel zero border, changed in place) through the
    ``allowed`` voxels, until a round changes nothing."""
    lab = padded[1:-1, 1:-1, 1:-1]
    neighbours = (padded[:-2, 1:-1, 1:-1], padded[2:, 1:-1, 1:-1],
                  padded[1:-1, :-2, 1:-1], padded[1:-1, 2:, 1:-1],
                  padded[1:-1, 1:-1, :-2], padded[1:-1, 1:-1, 2:])
    run = 1
    while True:
        for _ in range(run):
            prop = torch.maximum(neighbours[0], neighbours[1])
            for n in neighbours[2:]:
                torch.maximum(prop, n, out=prop)
            fill = (lab == 0) & allowed & (prop > 0)
            lab.copy_(torch.where(fill, prop, lab))
        stats["rounds"] += run
        stats["checks"] += 1
        if not bool(fill.any()):
            return
        run = min(2 * run, MAX_ROUNDS_PER_CHECK)


def flood_levels(intensity, markers, mask, stats=None):
    """The device flood: ``intensity`` (uint8), ``markers`` (integer
    labels, 0 = none) and ``mask`` (bool) are (Z, Y, X) tensors on one
    device, or ``intensity`` is None for the one-level mask flood.
    Returns int32 labels on that device, equal to
    ``watershed_descending`` (``mask_watershed``). ``stats`` gets the
    levels, rounds and convergence checks."""
    stats = stats if stats is not None else {}
    stats.update(levels=0, rounds=0, checks=0)
    padded = F.pad(markers.to(torch.int32)[None, None],
                   (1, 1, 1, 1, 1, 1))[0, 0]
    if intensity is None:
        stats["levels"] = 1
        _flood(padded, mask, stats)
        return padded[1:-1, 1:-1, 1:-1]
    counts = torch.bincount(((intensity.long() + 1) * mask).flatten(),
                            minlength=257)[1:]
    levels = torch.nonzero(counts).flatten().tolist()[::-1]
    stats["levels"] = len(levels)
    for lvl in levels:
        _flood(padded, mask & (intensity >= lvl), stats)
    return padded[1:-1, 1:-1, 1:-1]


# --- decoding ----------------------------------------------------------------

def _thresholds(thres1, thres2, thres3):
    return int(255 * thres1), int(255 * thres2), int(255 * thres3)


def _finish(segm, min_size, label_divisor):
    segm = segm.astype(np.uint32)
    if min_size is not None:
        segm = size_threshold_3d(segm, min_size)
    segm[segm > 0] += label_divisor
    return cast2dtype(segm)


def bc_watershed(volume, thres1=0.9, thres2=0.8, thres3=0.85,
                 seed_thres=32, min_size=128, label_divisor=1000,
                 use_mask_wts=False, device=None, stats=None):
    """Foreground + contour uint8 maps -> instance labels (numpy, the
    smallest uint dtype that holds them).

    ``volume``: (2, Z, Y, X) uint8 [semantic*255, contour*255], numpy or
    a tensor. The flood runs on ``device`` (CUDA unless named; raises
    without a card when none is named); the seeds' components and the
    size thresholds run on the host. ``stats``: as ``flood_levels``."""
    device = resolve_device(device)
    assert volume.shape[0] == 2
    volume = torch.as_tensor(volume).to(device)
    t1, t2, t3 = _thresholds(thres1, thres2, thres3)
    semantic, boundary = volume[0], volume[1]
    seed_map = (semantic > t1) & (boundary < t2)
    foreground = semantic > t3

    seed = connected_components_3d(
        seed_map.cpu().numpy().astype(np.uint8), 26)
    seed = size_threshold_3d(seed, seed_thres)
    markers = torch.from_numpy(seed.astype(np.int32)).to(device)
    segm = flood_levels(None if use_mask_wts else semantic, markers,
                        foreground, stats)
    return _finish(segm.cpu().numpy(), min_size, label_divisor)


def bc_watershed_numpy(volume, thres1=0.9, thres2=0.8, thres3=0.85,
                       seed_thres=32, min_size=128, label_divisor=1000,
                       use_mask_wts=False):
    """The plain version of ``bc_watershed``: the JAX package's numpy
    decoding, on the host."""
    assert volume.shape[0] == 2
    t1, t2, t3 = _thresholds(thres1, thres2, thres3)
    semantic = volume[0]
    boundary = volume[1]
    seed_map = (semantic > t1) & (boundary < t2)
    foreground = semantic > t3

    seed = connected_components_3d(seed_map.astype(np.uint8), 26)
    seed = size_threshold_3d(seed, seed_thres)

    if use_mask_wts:
        segm = mask_watershed(foreground, seed)
    else:
        segm = watershed_descending(semantic, seed, foreground)
    return _finish(segm, min_size, label_divisor)
