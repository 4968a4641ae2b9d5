"""Run-based connected-component labeling and region properties.

Replaces the reference's external cc3d / skimage.measure dependencies
(reference empanada/inference/rle.py:18-24, matcher.py:72-78) with a
union-find over row-split runs: O(#runs * alpha) instead of per-pixel work.
C++ fast path in core/_native/core.cpp (etpu_encode_runs_i32,
etpu_runs_ccl) through core/native.py; the numpy/python code below is
its plain version.

Connectivity semantics match cc3d: 8-connectivity in 2D, and components
are computed *within* each distinct non-zero value (multi-label CCL).
"""

from __future__ import annotations

import numpy as np

from empanada_torch.core import native
from empanada_torch.core.rle import rle_encode

__all__ = [
    "image_to_runs",
    "runs_connected_components",
    "connected_components_2d",
    "label_mask",
    "region_props_from_runs",
]


def image_to_runs(img: np.ndarray):
    """Encode a 2D integer image into row-split constant-value runs.

    Returns (starts, ends, values) over the raveled image; runs never
    cross row boundaries.
    """
    img = np.ascontiguousarray(img)
    h, w = img.shape
    out = native.encode_runs(img.astype(np.int32, copy=False), w)
    if out is not None:
        return out

    flat = img.ravel()
    n = flat.size
    # boundary where value changes or at row starts
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = flat[1:] != flat[:-1]
    change[::w] = True
    starts = np.nonzero(change)[0].astype(np.int64)
    ends = np.concatenate([starts[1:], [n]]).astype(np.int64)
    values = flat[starts].astype(np.int64)
    return starts, ends, values


def _runs_ccl_python(starts, ends, values, width, connectivity=8):
    """Pure-python union-find CCL over row-split runs (the plain
    version of etpu_runs_ccl)."""
    n = len(starts)
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    pad = 1 if connectivity == 8 else 0
    rows = starts // width

    # iterate row pairs
    row_start_idx = np.nonzero(np.concatenate([[True], rows[1:] != rows[:-1]]))[0]
    row_ids = rows[row_start_idx]
    row_bounds = np.concatenate([row_start_idx, [n]])

    for k in range(len(row_ids) - 1):
        if row_ids[k + 1] != row_ids[k] + 1:
            continue
        p0, p1 = row_bounds[k], row_bounds[k + 1]
        q0, q1 = row_bounds[k + 1], row_bounds[k + 2]
        p = p0
        for q in range(q0, q1):
            qs = starts[q] % width
            qe = (ends[q] - 1) % width + 1
            while p < p1 and ((ends[p] - 1) % width + 1) + pad <= qs:
                p += 1
            pp = p
            while pp < p1:
                ps = starts[pp] % width
                if ps >= qe + pad:
                    break
                if values[pp] == values[q]:
                    rp, rq = find(pp), find(q)
                    if rp != rq:
                        parent[max(rp, rq)] = min(rp, rq)
                pp += 1

    labels = np.zeros(n, dtype=np.int32)
    root_label = {}
    next_label = 0
    for i in range(n):
        r = find(i)
        if r not in root_label:
            next_label += 1
            root_label[r] = next_label
        labels[i] = root_label[r]
    return labels, next_label


def runs_connected_components(starts, ends, values, width,
                              connectivity: int = 8):
    """Per-run component labels (1-based, raster order) and component count.

    Only runs with identical values can belong to the same component;
    callers should pre-filter background runs (value 0) if background
    must stay unlabeled.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    if len(starts) == 0:
        return np.zeros(0, dtype=np.int32), 0
    out = native.runs_ccl(starts, ends, values, width, connectivity)
    if out is not None:
        return out
    return _runs_ccl_python(starts, ends, values, width, connectivity)


def connected_components_2d(seg: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """Multi-label 2D CCL: relabels each connected same-value region with a
    unique id (1-based). Background (0) stays 0. cc3d-equivalent."""
    h, w = seg.shape
    starts, ends, values = image_to_runs(seg)
    fg = values != 0
    starts, ends, values = starts[fg], ends[fg], values[fg]
    labels, _ = runs_connected_components(starts, ends, values, w, connectivity)

    out = np.zeros(h * w, dtype=np.int32)
    if len(starts):
        # vectorized fill: expand run extents
        lens = ends - starts
        idx = np.repeat(starts, lens) + _within_run_offsets(lens)
        out[idx] = np.repeat(labels, lens)
    return out.reshape(h, w)


def _within_run_offsets(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated."""
    total = int(lens.sum())
    if total == 0:
        return np.array([], dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = 0
    run_starts = np.cumsum(lens)[:-1]
    out[run_starts] -= lens[:-1]
    return np.cumsum(out)


def label_mask(mask: np.ndarray, connectivity: int = 8) -> np.ndarray:
    """Binary-mask CCL (skimage.measure.label equivalent)."""
    return connected_components_2d(mask.astype(np.int32), connectivity)


def region_props_from_runs(starts, ends, labels, shape):
    """Per-label geometry from labeled row-split runs over a 2D image.

    Returns dict: label -> {'box': (y1, x1, y2, x2), 'starts', 'runs',
    'area', 'centroid'}. Output RLE is canonical: sorted, disjoint, with
    row-crossing contiguous runs merged (matching the reference's
    rle_encode-of-sorted-coords output, rle.py:76-81).
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    labels = np.asarray(labels)
    h, w = shape

    props = {}
    if len(starts) == 0:
        return props

    order = np.argsort(labels, kind="stable")
    s_sorted = starts[order]
    e_sorted = ends[order]
    l_sorted = labels[order]
    first = np.concatenate([[True], l_sorted[1:] != l_sorted[:-1]])
    bounds = np.nonzero(first)[0]

    # all per-label reductions vectorized with reduceat: the per-label
    # python loop was ~50us/instance of small-array overhead and the
    # second-hottest host cost at realistic instance density
    lens = e_sorted - s_sorted
    rows = s_sorted // w
    cs = s_sorted % w
    ce = (e_sorted - 1) % w + 1
    area = np.add.reduceat(lens, bounds)
    y1 = np.minimum.reduceat(rows, bounds)
    y2 = np.maximum.reduceat(rows, bounds) + 1
    x1 = np.minimum.reduceat(cs, bounds)
    x2 = np.maximum.reduceat(ce, bounds)
    # weighted centroid over runs; column sum of an arithmetic run
    # [cs, ce) is lens*cs + lens*(lens-1)/2
    cy = np.add.reduceat(rows * lens, bounds) / area
    cx = np.add.reduceat(lens * cs + lens * (lens - 1) // 2, bounds) / area

    # merge row-crossing contiguous runs into canonical minimal RLE,
    # across the whole array at once (label changes always break a merge
    # because a new label's first run can't start at the previous end
    # within the same raster position unless labels differ -> force it)
    keep = np.concatenate([[True], s_sorted[1:] != e_sorted[:-1]]) | first
    group = np.cumsum(keep) - 1
    m_starts = s_sorted[keep]
    m_lens = np.zeros(len(m_starts), dtype=np.int64)
    np.add.at(m_lens, group, lens)
    # per-label extents in the merged arrays
    m_bounds = group[bounds]
    m_ends_idx = np.concatenate([m_bounds[1:], [len(m_starts)]])

    for bi in range(len(bounds)):
        lab = int(l_sorted[bounds[bi]])
        i0, i1 = m_bounds[bi], m_ends_idx[bi]
        props[lab] = {
            "box": (int(y1[bi]), int(x1[bi]), int(y2[bi]), int(x2[bi])),
            "starts": m_starts[i0:i1],
            "runs": m_lens[i0:i1],
            "area": int(area[bi]),
            "centroid": (float(cy[bi]), float(cx[bi])),
        }
    return props


def _merge_adjacent_runs(starts: np.ndarray, lens: np.ndarray):
    """Merge runs where start == previous end (raster-sorted input)."""
    if len(starts) == 0:
        return starts, lens
    ends = starts + lens
    keep = np.concatenate([[True], starts[1:] != ends[:-1]])
    group = np.cumsum(keep) - 1
    out_starts = starts[keep]
    out_lens = np.zeros(len(out_starts), dtype=np.int64)
    np.add.at(out_lens, group, lens)
    return out_starts, out_lens
