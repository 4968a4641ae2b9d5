"""3D connected components over row-split runs.

Replaces cc3d.connected_components(connectivity=26|6) (reference
watershed.py:25-29) with the same run-based union-find approach as the 2D
path (core/ccl.py): rows are (z, y) lines, adjacency = row pairs within a
slice, across slices, and (for 26-connectivity) across slice diagonals,
with ±1 column tolerance for diagonal touch. The union-find runs in
the C++ host core (etpu_runs_ccl3d through core/native.py); the python
union-find below is its plain version.
"""

from __future__ import annotations

import numpy as np

from empanada_torch.core.ccl import _within_run_offsets, image_to_runs

__all__ = ["connected_components_3d", "size_threshold_3d"]


class _UnionFind:
    def __init__(self, n):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x):
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def _union_row_pair(uf, starts, ends, values, width, i0, i1, j0, j1, tol):
    """Union overlapping same-value runs between two row-run spans."""
    p = i0
    for q in range(j0, j1):
        qs = starts[q] % width
        qe = (ends[q] - 1) % width + 1
        while p < i1 and ((ends[p] - 1) % width + 1) + tol <= qs:
            p += 1
        pp = p
        while pp < i1:
            ps = starts[pp] % width
            if ps >= qe + tol:
                break
            if values[pp] == values[q]:
                uf.union(pp, q)
            pp += 1


def connected_components_3d(vol, connectivity=26):
    """Multi-label 3D CCL, 1-based component ids, background 0.

    connectivity: 26 (full) or 6 (faces only), cc3d semantics.
    """
    from empanada_torch.core import native

    vol = np.asarray(vol)
    d, h, w = vol.shape
    # runs of the (d*h, w) row-major view; rows never cross
    starts, ends, values = image_to_runs(
        vol.reshape(d * h, w).astype(np.int32, copy=False))
    fg = values != 0
    starts, ends, values = starts[fg], ends[fg], values[fg]
    n = len(starts)
    if n == 0:
        return np.zeros((d, h, w), np.uint32)

    fast = native.runs_ccl3d(starts, ends, values, d, h, w, connectivity)
    if fast is not None:
        return _paint(starts, ends, fast[0].astype(np.int64), (d, h, w))

    rows = (starts // w).astype(np.int64)  # global row id = z*h + y
    # span index: for each global row, [lo, hi) into the run arrays
    row_lo = np.searchsorted(rows, np.arange(d * h), side="left")
    row_hi = np.searchsorted(rows, np.arange(d * h), side="right")

    uf = _UnionFind(n)
    tol_inplane = 1 if connectivity == 26 else 0
    # neighbor row offsets (dz, dy) -> (tolerance)
    if connectivity == 26:
        neighbor_rows = [(0, 1, 1), (1, 0, 1), (1, -1, 1), (1, 1, 1)]
    else:
        neighbor_rows = [(0, 1, 0), (1, 0, 0)]

    nonempty = np.nonzero(row_hi > row_lo)[0]
    for r in nonempty:
        z, y = divmod(int(r), h)
        for dz, dy, tol in neighbor_rows:
            z2, y2 = z + dz, y + dy
            if not (0 <= z2 < d and 0 <= y2 < h):
                continue
            r2 = z2 * h + y2
            if row_hi[r2] > row_lo[r2]:
                _union_row_pair(uf, starts, ends, values, w,
                                row_lo[r], row_hi[r],
                                row_lo[r2], row_hi[r2], tol)

    # canonical labels in raster order
    roots = np.array([uf.find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return _paint(starts, ends, labels.astype(np.int64) + 1, (d, h, w))


def _paint(starts, ends, labels, shape):
    """Dense uint32 volume with each run filled with its label."""
    out = np.zeros(int(np.prod(shape)), np.uint32)
    lens = ends - starts
    idx = np.repeat(starts, lens) + _within_run_offsets(lens)
    out[idx] = np.repeat(labels, lens)
    return out.reshape(shape)


def size_threshold_3d(seg, threshold, relabel=False):
    """Remove components smaller than threshold voxels (cc3d.dust /
    skimage.remove_small_objects equivalent). seg must be a labelmap
    where distinct instances already have distinct ids; with
    ``relabel`` the survivors are renumbered compactly 1..N."""
    seg = np.asarray(seg)
    if threshold is None or threshold <= 1:
        if not relabel:
            return seg
        counts = np.bincount(seg.reshape(-1).astype(np.int64))
        small = np.zeros(0, np.int64)
    else:
        flat = seg.reshape(-1)
        counts = np.bincount(flat.astype(np.int64))
        small = np.nonzero(counts < threshold)[0]
        if len(small) == 0 and not relabel:
            return seg
    lut = np.arange(len(counts), dtype=np.int64)
    lut[small] = 0
    lut[0] = 0
    if relabel:
        survivors = np.unique(lut[lut > 0])
        remap = np.zeros(len(counts), np.int64)
        remap[survivors] = np.arange(1, len(survivors) + 1)
        lut = remap[lut]
    return lut[seg.reshape(-1)].reshape(seg.shape).astype(seg.dtype)
