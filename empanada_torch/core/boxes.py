"""Bounding-box algebra for 2D (y1, x1, y2, x2) and 3D (z1, y1, x1, z2, y2, x2)
half-open boxes.

Capability parity with reference empanada/array_utils.py:42-207, re-implemented
as fully vectorized numpy (the reference uses a numba O(n*m) loop for the
sparse IoU; here candidate pairs come from a vectorized sweep instead).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "box_area",
    "box_intersection",
    "merge_boxes",
    "box_iou_dense",
    "box_iou_pairs",
]


def box_area(boxes: np.ndarray) -> np.ndarray:
    """Areas/volumes of an (n, 2*ndim) array of boxes."""
    boxes = np.asarray(boxes)
    ndim = boxes.shape[1] // 2
    return np.prod(boxes[:, ndim:] - boxes[:, :ndim], axis=1)


def box_intersection(boxes1: np.ndarray, boxes2: np.ndarray | None = None) -> np.ndarray:
    """Pairwise intersection area/volume matrix of shape (n, m).

    Computed per dimension with ufunc .outer products: the obvious
    (n, m, ndim) broadcast + np.clip(..., 0, None) form was 20-40x
    slower at consensus scale (np.clip with a None bound takes numpy's
    slow path; profiled 38 s of a 66 s 15k-box consensus)."""
    boxes1 = np.asarray(boxes1)
    boxes2 = boxes1 if boxes2 is None else np.asarray(boxes2)
    ndim = boxes1.shape[1] // 2

    inter = None
    for d in range(ndim):
        lo = np.maximum.outer(boxes1[:, d], boxes2[:, d])
        hi = np.minimum.outer(boxes1[:, ndim + d], boxes2[:, ndim + d])
        ext = hi - lo
        np.maximum(ext, 0, out=ext)
        inter = ext if inter is None else np.multiply(inter, ext, out=inter)
    return inter


def merge_boxes(box1, box2):
    """Smallest box enclosing both boxes (tuple in, tuple out)."""
    n = len(box1)
    ndim = n // 2
    return tuple(
        min(box1[i], box2[i]) if i < ndim else max(box1[i], box2[i])
        for i in range(n)
    )


def merge_boxes_many(boxes: np.ndarray):
    """Enclosing box of an (n, 2*ndim) array of boxes."""
    boxes = np.asarray(boxes)
    ndim = boxes.shape[1] // 2
    return tuple(boxes[:, :ndim].min(0)) + tuple(boxes[:, ndim:].max(0))


def box_iou_dense(boxes1: np.ndarray, boxes2: np.ndarray | None = None,
                  return_intersection: bool = False):
    """Dense (n, m) pairwise IoU matrix."""
    boxes1 = np.asarray(boxes1)
    boxes2 = boxes1 if boxes2 is None else np.asarray(boxes2)
    inter = box_intersection(boxes1, boxes2)
    a1 = box_area(boxes1)
    a2 = box_area(boxes2)
    union = a1[:, None] + a2[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    if return_intersection:
        return iou, inter
    return iou


def box_iou_pairs(boxes1: np.ndarray, boxes2: np.ndarray | None = None,
                  block: int = 2048):
    """Sparse pairwise box IoU.

    Returns (rows, cols, ious, intersections) for all pairs with
    intersection > 0. Equivalent output to the reference's numba
    ``_box_iou`` (array_utils.py:144) but computed by blocked vectorized
    numpy so large n*m never materializes at once.
    """
    boxes1 = np.asarray(boxes1)
    self_pairs = boxes2 is None
    boxes2 = boxes1 if self_pairs else np.asarray(boxes2)

    n, m = len(boxes1), len(boxes2)
    a1 = box_area(boxes1)
    a2 = box_area(boxes2)

    if n * m > (1 << 16):
        # native bucketed sweep (core/_native): near-linear in true-pair
        # count; the numpy block path below is O(n*m) elementwise work,
        # which dominates consensus at thousands of 3D instances
        from empanada_torch.core import native

        hit = native.box_overlap_pairs(boxes1, None if self_pairs
                                       else boxes2)
        if hit is not None:
            pairs, inter = hit
            rows, cols = pairs[:, 0], pairs[:, 1]
            union = a1[rows] + a2[cols] - inter
            return rows, cols, inter / union, inter

    # sort-sweep prune on dim 0: with boxes2 sorted by lo0, a boxes1
    # block only intersects the boxes2 prefix whose lo0 < its max hi0
    # (everything after starts past the block's furthest end). Exact —
    # only provably-empty block pairs are skipped. At consensus scale
    # (10k+ 3D instances spread through a volume) this cuts the O(n*m)
    # blocked work to near-linear.
    order2 = np.argsort(boxes2[:, 0], kind="stable")
    b2_sorted = boxes2[order2]
    lo0_sorted = b2_sorted[:, 0]
    ndim = boxes1.shape[1] // 2

    rows_out, cols_out, iou_out, inter_out = [], [], [], []
    for i0 in range(0, n, block):
        b1 = boxes1[i0:i0 + block]
        j_end = int(np.searchsorted(lo0_sorted, b1[:, ndim].max(),
                                    side="left"))
        for j0 in range(0, j_end, block):
            b2 = b2_sorted[j0:min(j0 + block, j_end)]
            inter = box_intersection(b1, b2)
            r, c = np.nonzero(inter)
            if len(r) == 0:
                continue
            iv = inter[r, c]
            cols_orig = order2[j0 + c]
            union = a1[i0 + r] + a2[cols_orig] - iv
            rows_out.append(i0 + r)
            cols_out.append(cols_orig)
            iou_out.append(iv / union)
            inter_out.append(iv)

    if not rows_out:
        empty_i = np.array([], dtype=np.int64)
        return empty_i, empty_i.copy(), np.array([]), np.array([])

    return (
        np.concatenate(rows_out),
        np.concatenate(cols_out),
        np.concatenate(iou_out),
        np.concatenate(inter_out),
    )
