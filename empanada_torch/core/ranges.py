"""Interval (range) algebra over half-open [start, end) index ranges.

This is the heart of the sparse 3D pipeline: pixel voting, range joins,
complements and intersections. The reference implements these as numba
per-pixel loops (array_utils.py:340-688); here every operation is an
*event sweep*: convert ranges to (+1 at start, -1 at end) boundary events,
sort, and read coverage depth off a cumulative sum. This is O(E log E)
in the number of range endpoints, fully vectorized, and maps directly to
a single linear pass in the C++ fast path (``core/native.py``); the numpy
code below is the plain version of those entry points.

Coverage-depth semantics are identical to the reference's vote counting:
each source RLE contributes disjoint ranges, so the number of votes at an
index equals the number of ranges covering it.
"""

from __future__ import annotations

import numpy as np

from empanada_torch.core import native

__all__ = [
    "rle_to_ranges",
    "ranges_to_rle",
    "concat_sort_ranges",
    "join_ranges",
    "vote_by_ranges",
    "invert_ranges",
    "ranges_intersection",
]

_EMPTY = np.zeros((0, 2), dtype=np.int64)


def rle_to_ranges(rle: np.ndarray) -> np.ndarray:
    """(n, 2) [start, run] -> (n, 2) [start, end)."""
    rle = np.asarray(rle)
    out = rle.copy()
    out[:, 1] = rle[:, 0] + rle[:, 1]
    return out


def ranges_to_rle(ranges: np.ndarray) -> np.ndarray:
    """(n, 2) [start, end) -> (n, 2) [start, run]."""
    ranges = np.asarray(ranges)
    out = ranges.copy()
    out[:, 1] = ranges[:, 1] - ranges[:, 0]
    return out


def concat_sort_ranges(list_of_ranges) -> np.ndarray:
    """Concatenate multiple (n_i, 2) range arrays and sort by start."""
    list_of_ranges = [np.asarray(r).reshape(-1, 2) for r in list_of_ranges if len(r) > 0]
    if not list_of_ranges:
        return _EMPTY.copy()
    ranges = np.concatenate(list_of_ranges, axis=0)
    if len(list_of_ranges) > 1 and all(
            len(r) < 2 or bool(np.all(r[1:, 0] >= r[:-1, 0]))
            for r in list_of_ranges):
        # every input is already start-sorted (canonical RLEs — the
        # consensus vote path): a native k-way merge replaces the
        # argsort of the concatenation, bit-identical output (ties keep
        # concatenation order, like the stable argsort)
        offs = np.zeros(len(list_of_ranges) + 1, dtype=np.int64)
        offs[1:] = np.cumsum([len(r) for r in list_of_ranges])
        merged = native.kway_merge_ranges(ranges, offs)
        if merged is not None:
            return merged
    order = np.argsort(ranges[:, 0], kind="stable")
    return ranges[order]


def _coverage_ranges(ranges: np.ndarray, thr: int) -> np.ndarray:
    """Ranges where coverage depth >= thr, via boundary-event sweep."""
    if len(ranges) == 0:
        return _EMPTY.copy()
    ranges = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)

    out = native.coverage_ranges(ranges, thr)
    if out is not None:
        return out

    # numpy path: event sweep
    starts = ranges[:, 0]
    ends = ranges[:, 1]
    points = np.concatenate([starts, ends])
    deltas = np.concatenate([
        np.ones(len(starts), dtype=np.int64),
        -np.ones(len(ends), dtype=np.int64),
    ])
    order = np.argsort(points, kind="stable")
    points = points[order]
    deltas = deltas[order]

    # collapse duplicate points so depth transitions are well-defined
    uniq, idx = np.unique(points, return_index=True)
    depth_delta = np.add.reduceat(deltas, idx)
    depth = np.cumsum(depth_delta)

    above = depth >= thr
    trans_up = above & ~np.concatenate([[False], above[:-1]])
    trans_down = ~above & np.concatenate([[False], above[:-1]])

    out_starts = uniq[trans_up]
    out_ends = uniq[1:][trans_down[1:]]
    if above[-1]:  # coverage never drops below thr before final event
        out_ends = np.concatenate([out_ends, uniq[-1:]])
    return np.stack([out_starts, out_ends], axis=1)


def _kway_vote_fast(list_of_ranges, thr):
    """Native one-pass k-way coverage vote when every input is canonical
    (start-sorted AND disjoint — instance RLEs by construction); None
    when an input fails the check or the numpy host half is asked for."""
    if native.get_lib() is None:
        # bail before the canonicality scans + concatenate: the caller
        # repeats that packing work in its own concat-sort path
        return None
    cleaned = []
    for r in list_of_ranges:
        r = np.asarray(r, dtype=np.int64).reshape(-1, 2)
        if len(r) > 1 and not bool(np.all(r[1:, 0] >= r[:-1, 1])):
            return None
        cleaned.append(r)
    offs = np.zeros(len(cleaned) + 1, dtype=np.int64)
    offs[1:] = np.cumsum([len(r) for r in cleaned])
    cat = (np.concatenate(cleaned, axis=0) if len(cleaned) > 1
           else cleaned[0])
    return native.kway_vote(cat, offs, thr)


def join_ranges(list_of_ranges) -> np.ndarray:
    """Union of possibly-overlapping ranges -> disjoint sorted ranges."""
    list_of_ranges = [r for r in list_of_ranges if len(r) > 0]
    if not list_of_ranges:
        return _EMPTY.copy()
    out = _kway_vote_fast(list_of_ranges, 1)
    if out is not None:
        return out
    ranges = concat_sort_ranges(list_of_ranges)
    return _coverage_ranges(ranges, 1)


def vote_by_ranges(list_of_ranges, vote_thr: int = 2) -> np.ndarray:
    """Ranges covering indices that appear in >= vote_thr of the sources.

    Matches reference semantics (array_utils.py:539-615): with fewer than
    vote_thr non-empty sources the result is empty; vote_thr == 1 is a join.
    """
    list_of_ranges = [r for r in list_of_ranges if len(r) > 0]
    if vote_thr == 1:
        return join_ranges(list_of_ranges)
    if len(list_of_ranges) < vote_thr:
        return _EMPTY.copy()
    out = _kway_vote_fast(list_of_ranges, vote_thr)
    if out is not None:
        return out
    ranges = concat_sort_ranges(list_of_ranges)
    return _coverage_ranges(ranges, vote_thr)


def invert_ranges(ranges, size: int) -> np.ndarray:
    """Complement of disjoint sorted ranges within [0, size)."""
    ranges = np.asarray(ranges, dtype=np.int64).reshape(-1, 2)
    if len(ranges) == 0:
        return np.array([[0, size]], dtype=np.int64)
    # gaps are [prev_end, next_start): interleave [0, s0], [e0, s1], ..., [eN, size]
    gap_starts = np.concatenate([[0], ranges[:, 1]])
    gap_ends = np.concatenate([ranges[:, 0], [size]])
    keep = gap_starts < gap_ends
    return np.stack([gap_starts[keep], gap_ends[keep]], axis=1)


def ranges_intersection(ranges_a: np.ndarray, ranges_b: np.ndarray) -> int:
    """Total overlap (in indices) between two disjoint sorted range sets."""
    ranges_a = np.asarray(ranges_a, dtype=np.int64).reshape(-1, 2)
    ranges_b = np.asarray(ranges_b, dtype=np.int64).reshape(-1, 2)
    if len(ranges_a) == 0 or len(ranges_b) == 0:
        return 0

    out = native.ranges_intersection(ranges_a, ranges_b)
    if out is not None:
        return out

    # numpy path, vectorized: for each a-range, clip against candidate b-ranges
    # via searchsorted on b starts/ends.
    bs, be = ranges_b[:, 0], ranges_b[:, 1]
    # index of first b-range whose end is > a.start
    lo = np.searchsorted(be, ranges_a[:, 0], side="right")
    # index of first b-range whose start is >= a.end
    hi = np.searchsorted(bs, ranges_a[:, 1], side="left")

    total = 0
    # sum of full b-ranges inside each [lo, hi) window, minus clipped edges:
    # do it exactly with a prefix-sum of b lengths and edge corrections.
    blen = be - bs
    pref = np.concatenate([[0], np.cumsum(blen)])
    full = pref[hi] - pref[lo]
    # corrections: clip the first and last overlapping b-range to a's bounds
    has = hi > lo
    a_s = ranges_a[:, 0]
    a_e = ranges_a[:, 1]
    first_cut = np.where(has, np.clip(a_s - bs[np.minimum(lo, len(bs) - 1)], 0, None), 0)
    last_idx = np.maximum(hi - 1, 0)
    last_cut = np.where(has, np.clip(be[last_idx] - a_e, 0, None), 0)
    total = int(np.sum(full - first_cut - last_cut))
    return total
