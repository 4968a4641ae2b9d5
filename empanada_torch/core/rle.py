"""Run-length-encoding algebra over raveled indices.

API parity with reference empanada/array_utils.py:209-723; set operations
are delegated to the event-sweep range algebra in
``empanada_torch.core.ranges`` instead of numba scan loops.

The canonical sparse instance representation used across the framework is
the dict ``{'box': tuple, 'starts': int64[n], 'runs': int64[n]}`` with
starts sorted ascending and runs disjoint (same contract as the
reference's tracker/matcher/consensus layers).
"""

from __future__ import annotations

import numpy as np

from empanada_torch.core.ranges import (
    join_ranges,
    ranges_intersection,
    ranges_to_rle,
    rle_to_ranges,
)

__all__ = [
    "rle_encode",
    "rle_decode",
    "rle_to_string",
    "string_to_rle",
    "canonicalize_rle",
    "rle_intersection",
    "rle_iou",
    "rle_ioa",
    "merge_rles",
    "rle_area",
    "crop_and_binarize",
    "mask_iou",
    "mask_ioa",
]


def rle_encode(indices: np.ndarray):
    """Encode a sorted array of raveled indices into (starts, runs)."""
    indices = np.asarray(indices, dtype=np.int64)
    if len(indices) == 0:
        e = np.array([], dtype=np.int64)
        return e, e.copy()
    breaks = np.nonzero(indices[1:] != indices[:-1] + 1)[0] + 1
    bounds = np.concatenate([[0], breaks, [len(indices)]])
    starts = indices[bounds[:-1]]
    runs = bounds[1:] - bounds[:-1]
    return starts, runs


def rle_decode(starts: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """Decode (starts, runs) back into a flat array of indices."""
    starts = np.asarray(starts, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    if len(starts) == 0:
        return np.array([], dtype=np.int64)
    total = int(runs.sum())
    # vectorized expansion: offsets within a flat output
    out = np.ones(total, dtype=np.int64)
    run_ends = np.cumsum(runs)
    run_starts_in_out = np.concatenate([[0], run_ends[:-1]])
    out[run_starts_in_out] = starts - np.concatenate([[0], starts[:-1] + runs[:-1]]) + 1
    out[0] = starts[0]
    return np.cumsum(out)


def rle_area(runs: np.ndarray) -> int:
    return int(np.asarray(runs).sum())


def rle_to_string(starts, runs) -> str:
    """Interchange string format: 's0 r0 s1 r1 ...' (same as reference)."""
    pairs = np.empty(2 * len(starts), dtype=np.int64)
    pairs[0::2] = starts
    pairs[1::2] = runs
    return " ".join(map(str, pairs.tolist()))


def string_to_rle(encoding: str):
    if not encoding:
        e = np.array([], dtype=np.int64)
        return e, e.copy()
    flat = np.array(encoding.split(" "), dtype=np.int64)
    return flat[0::2], flat[1::2]


def _as_ranges(starts, runs):
    starts = np.asarray(starts, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    return np.stack([starts, starts + runs], axis=1)


def canonicalize_rle(starts, runs):
    """Sort + coalesce an RLE into this package's canonical form
    (ascending disjoint runs).

    Every RLE op here assumes canonical inputs; our own trackers always
    emit them, but the reference's axis trackers (tracker.py finish())
    can emit UNSORTED runs — feeding those in unguarded silently
    computes near-zero IoUs. Call this at ingestion boundaries
    (cross-ecosystem JSON, foreign tracker objects). No-op (no copy)
    when already canonical."""
    starts = np.asarray(starts, dtype=np.int64)
    runs = np.asarray(runs, dtype=np.int64)
    if len(starts) < 2:
        return starts, runs
    ends = starts + runs
    if np.all(starts[1:] >= ends[:-1]):
        return starts, runs
    order = np.argsort(starts, kind="stable")
    joined = ranges_to_rle(join_ranges(
        [np.stack([starts[order], ends[order]], axis=1)]))
    return joined[:, 0], joined[:, 1]


def rle_intersection(starts_a, runs_a, starts_b, runs_b) -> int:
    """Number of overlapping indices between two RLEs."""
    return ranges_intersection(_as_ranges(starts_a, runs_a),
                               _as_ranges(starts_b, runs_b))


def rle_pairwise_intersections(starts_a, runs_a, starts_b, runs_b,
                               rows, cols):
    """Intersection sizes for many instance pairs in ONE native call.

    ``starts_x``/``runs_x`` are lists of per-instance canonical RLE
    arrays; ``rows``/``cols`` index pairs (a_i, b_j). The slice matcher
    builds its IoU/IoA matrices from thousands of pairs per slice —
    per-pair ctypes calls were the single hottest host cost at realistic
    instance density (~12 ms/slice of the ~15 ms host budget)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if len(rows) == 0:
        return np.zeros(0, dtype=np.int64)

    from empanada_torch.core import native

    def _pack(starts, runs):
        # one C-level concatenate per column — the per-instance python
        # copy loop was ~11 s at consensus scale (10M+ runs across 3D
        # instance RLEs)
        offs = np.zeros(len(starts) + 1, dtype=np.int64)
        offs[1:] = np.cumsum([len(s) for s in starts])
        s_cat = (np.concatenate(starts) if len(starts) > 1
                 else np.asarray(starts[0])).astype(np.int64, copy=False)
        r_cat = (np.concatenate(runs) if len(runs) > 1
                 else np.asarray(runs[0])).astype(np.int64, copy=False)
        cat = np.empty((len(s_cat), 2), dtype=np.int64)
        cat[:, 0] = s_cat
        cat[:, 1] = s_cat + r_cat
        return cat, offs

    cat_a, offs_a = _pack(starts_a, runs_a)
    if starts_b is starts_a and runs_b is runs_a:
        cat_b, offs_b = cat_a, offs_a  # self mode: pack once
    else:
        cat_b, offs_b = _pack(starts_b, runs_b)

    pairs = np.stack([rows, cols], axis=1)
    out = native.pair_intersections(cat_a, offs_a, cat_b, offs_b, pairs)
    if out is not None:
        return out
    return np.array([
        ranges_intersection(cat_a[offs_a[i]:offs_a[i + 1]],
                            cat_b[offs_b[j]:offs_b[j + 1]])
        for i, j in zip(rows, cols)], dtype=np.int64)


def rle_iou(starts_a, runs_a, starts_b, runs_b, return_intersection=False):
    inter = rle_intersection(starts_a, runs_a, starts_b, runs_b)
    union = int(np.sum(runs_a)) + int(np.sum(runs_b)) - inter
    iou = inter / union if union > 0 else 0.0
    if return_intersection:
        return iou, inter
    return iou


def rle_ioa(starts_a, runs_a, starts_b, runs_b, return_intersection=False):
    """Intersection over the area of the *second* RLE (reference convention,
    array_utils.py:431-455)."""
    inter = rle_intersection(starts_a, runs_a, starts_b, runs_b)
    area = int(np.sum(runs_b))
    ioa = inter / area if area > 0 else 0.0
    if return_intersection:
        return ioa, inter
    return ioa


def _is_sorted_disjoint(ranges):
    return len(ranges) < 2 or bool(
        np.all(ranges[1:, 0] >= ranges[:-1, 1]))


def merge_rles(starts_a, runs_a, starts_b=None, runs_b=None):
    """Union of one or two RLEs into a canonical disjoint sorted RLE."""
    ra = _as_ranges(starts_a, runs_a)
    if starts_b is not None and runs_b is not None:
        rb = _as_ranges(starts_b, runs_b)
        if _is_sorted_disjoint(ra) and _is_sorted_disjoint(rb):
            # hot path (matcher false-split healing): both inputs are
            # already canonical — one native two-pointer merge instead
            # of the generic concat+sort+coverage-sweep chain
            from empanada_torch.core import native

            out = native.rle_union(ra, rb)
            if out is not None:
                return out[:, 0], out[:, 1] - out[:, 0]
        ranges = [ra, rb]
    else:
        ranges = [ra]
    joined = ranges_to_rle(join_ranges(ranges))
    return joined[:, 0], joined[:, 1]


# --- dense-mask helpers (used by tests and train-time metrics) -------------

def crop_and_binarize(mask: np.ndarray, box, label) -> np.ndarray:
    ndim = len(box) // 2
    slices = tuple(slice(box[i], box[i + ndim]) for i in range(ndim))
    return mask[slices] == label


def mask_iou(mask1, mask2, return_intersection=False):
    inter = int(np.count_nonzero(np.logical_and(mask1, mask2)))
    union = int(np.count_nonzero(np.logical_or(mask1, mask2)))
    iou = inter / union if union > 0 else 0.0
    if return_intersection:
        return iou, inter
    return iou


def mask_ioa(mask1, mask2):
    inter = int(np.count_nonzero(np.logical_and(mask1, mask2)))
    area = int(np.count_nonzero(mask2))
    return inter / area if area > 0 else 0.0
