"""Instance matching across consecutive slices (host side).

Parity with reference inference/matcher.py:30-326: box-IoU screening, RLE
IoU matrices, Hungarian assignment (scipy linear_sum_assignment), and the
stateful per-class RLEMatcher with false-split healing (unmatched
instances with IoA >= merge_ioa_thr merge into the argmax-IoA target).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

from empanada_torch.core.boxes import box_iou_pairs
from empanada_torch.core.rle import rle_pairwise_intersections
from empanada_torch.inference.rle import get_canon, unpack_rle_attrs

__all__ = ["rle_matcher", "RLEMatcher", "merge_attrs", "merge_attrs_many",
           "merge_attrs_batch", "fast_matcher"]


def merge_attrs(rle_attr1, rle_attr2):
    """Merge two instance attr dicts (enclosing box, union RLE)."""
    return merge_attrs_many([rle_attr1, rle_attr2])


def _canon_sr(attrs):
    c = get_canon(attrs)
    return (c[0], c[1]) if c else (attrs["starts"], attrs["runs"])


def merge_attrs_many(attrs_list):
    """Union of k instance attr dicts in ONE native k-way merge (the
    matcher's false-split healing can route several instances into the
    same target; pairwise chained merges re-swept the accumulated RLE
    each time and paid a native-call crossing per pair)."""
    if len(attrs_list) == 1:
        return attrs_list[0]
    pairs = [_canon_sr(a) for a in attrs_list]
    starts, runs = _union_sr_many(pairs, [get_canon(a) is not None
                                          for a in attrs_list])
    boxes = np.asarray([a["box"] for a in attrs_list], dtype=np.int64)
    nd = boxes.shape[1] // 2
    box = tuple(int(v) for v in boxes[:, :nd].min(axis=0)) + \
        tuple(int(v) for v in boxes[:, nd:].max(axis=0))
    return {
        "box": box,
        "starts": starts,
        "runs": runs,
        # every union path emits canonical output
        "_canon": (starts, runs, int(np.sum(runs)), starts),
    }


def merge_attrs_batch(groups_lists):
    """Union each group of instance attr dicts — all groups in ONE
    native crossing (core/native.kway_union_batch). Same outputs as
    [merge_attrs_many(g) for g in groups_lists]; falls back to exactly
    that when an input is non-canonical or the numpy host half is asked
    for."""
    from empanada_torch.core import native

    arrs, flags, group_sizes = [], [], []
    for lst in groups_lists:
        group_sizes.append(len(lst))
        for a in lst:
            s, r = _canon_sr(a)
            arrs.append((np.asarray(s, np.int64), np.asarray(r, np.int64)))
            flags.append(get_canon(a) is not None)
    out = None
    packed = (_pack_canonical(arrs, flags)
              if len(arrs) > 1 and native.get_lib() is not None
              else None)
    if packed is not None:
        group_offs = np.zeros(len(groups_lists) + 1, dtype=np.int64)
        group_offs[1:] = np.cumsum(group_sizes)
        out = native.kway_union_batch(*packed, group_offs)
    if out is None:
        return [merge_attrs_many(lst) for lst in groups_lists]
    out_s, out_r, out_offs = out

    # enclosing boxes: one reduceat pair over all groups
    boxes = np.asarray([a["box"] for lst in groups_lists for a in lst],
                       dtype=np.int64)
    nd = boxes.shape[1] // 2
    seg = np.zeros(len(groups_lists) + 1, dtype=np.int64)
    seg[1:] = np.cumsum(group_sizes)
    lo = np.minimum.reduceat(boxes[:, :nd], seg[:-1], axis=0)
    hi = np.maximum.reduceat(boxes[:, nd:], seg[:-1], axis=0)

    merged = []
    for i in range(len(groups_lists)):
        s = out_s[out_offs[i]:out_offs[i + 1]]
        r = out_r[out_offs[i]:out_offs[i + 1]]
        merged.append({
            "box": tuple(int(v) for v in lo[i]) + tuple(int(v)
                                                        for v in hi[i]),
            "starts": s,
            "runs": r,
            "_canon": (s, r, int(np.sum(r)), s),
        })
    return merged


def _pack_canonical(arrs, canon_flags):
    """Flat-pack k (starts, runs) int64 pairs for the native k-way
    union kernels: (s_cat, r_cat, offs), or None when any input fails
    the canonicality check (start-sorted AND disjoint; skipped for
    inputs pre-flagged canonical via ``_canon``). The single shared
    definition of the canonical-RLE predicate for both union paths."""
    ok = all(
        flag or len(s) < 2 or bool(np.all(s[1:] >= s[:-1] + r[:-1]))
        for (s, r), flag in zip(arrs, canon_flags))
    if not ok:
        return None
    offs = np.zeros(len(arrs) + 1, dtype=np.int64)
    offs[1:] = np.cumsum([len(s) for s, _ in arrs])
    s_cat = (np.concatenate([s for s, _ in arrs])
             if len(arrs) > 1 else arrs[0][0])
    r_cat = (np.concatenate([r for _, r in arrs])
             if len(arrs) > 1 else arrs[0][1])
    return s_cat, r_cat, offs


def _union_sr_many(pairs, canon_flags):
    """Union of k (starts, runs) RLEs -> canonical (starts, runs).

    Takes the native k-way starts/runs merge when every input is
    canonical (guaranteed for attrs carrying ``_canon``; checked O(n)
    otherwise); falls back to the generic sort+coverage join."""
    from empanada_torch.core import native

    arrs = [(np.asarray(s, np.int64), np.asarray(r, np.int64))
            for s, r in pairs]
    packed = (_pack_canonical(arrs, canon_flags)
              if native.get_lib() is not None else None)
    if packed is not None:
        out = native.kway_union_sr(*packed)
        if out is not None:
            return out
    from empanada_torch.core.ranges import join_ranges, ranges_to_rle

    ranges = [np.stack([s, s + r], axis=1) for s, r in arrs]
    joined = ranges_to_rle(join_ranges(ranges))
    return joined[:, 0], joined[:, 1]


def rle_matcher(target_instance_rles, match_instance_rles, iou_thr=0.5,
                return_iou=False, return_ioa=False):
    """Hungarian matching between two RLE instance dicts.

    Returns (matched_labels (target, match), all_labels, matched_ious
    [, iou_matrix][, ioa_matrix]) with the reference's exact conventions.
    """
    target_labels, target_boxes, target_starts, target_runs, area_t = \
        unpack_rle_attrs(target_instance_rles, return_areas=True)
    match_labels, match_boxes, match_starts, match_runs, area_m = \
        unpack_rle_attrs(match_instance_rles, return_areas=True)

    if len(target_labels) == 0 or len(match_labels) == 0:
        empty = np.array([])
        out = ((empty, empty), (target_labels, match_labels), empty)
        if return_iou:
            out = out + (empty,)
        if return_ioa:
            out = out + (empty,)
        return out

    iou_matrix = np.zeros((len(target_labels), len(match_labels)))
    ioa_matrix = np.zeros_like(iou_matrix) if return_ioa else None

    rows, cols, _, _ = box_iou_pairs(target_boxes, match_boxes)
    if len(rows):
        # all screened pairs in one native call (per-pair rle_iou calls
        # are the dominant host cost at realistic instance density)
        inter = rle_pairwise_intersections(
            target_starts, target_runs, match_starts, match_runs,
            rows, cols).astype(np.float64)
        union = area_t[rows] + area_m[cols] - inter
        iou_matrix[rows, cols] = np.where(union > 0, inter / union, 0.0)
        if return_ioa:
            # intersection over the area of the SECOND (match) RLE,
            # reference convention (array_utils.py:431-455)
            ioa_matrix[rows, cols] = np.where(
                area_m[cols] > 0, inter / area_m[cols], 0.0)

    match_rows, match_cols = linear_sum_assignment(iou_matrix, maximize=True)
    if iou_thr is not None:
        keep = iou_matrix[match_rows, match_cols] >= iou_thr
        match_rows, match_cols = match_rows[keep], match_cols[keep]

    matched_labels = (target_labels[match_rows], match_labels[match_cols])
    matched_ious = iou_matrix[match_rows, match_cols]
    out = (matched_labels, [target_labels, match_labels], matched_ious)
    if return_iou:
        out = out + (iou_matrix,)
    if return_ioa:
        out = out + (ioa_matrix,)
    return out


def fast_matcher(target_instance_seg, match_instance_seg, iou_thr=0.5,
                 return_iou=False, return_ioa=False):
    """Dense-mask Hungarian matching for 2D or 3D label maps (train-time
    metrics path, reference matcher.py:30-134). Implemented by
    RLE-encoding both masks first — same outputs, one code path."""
    return rle_matcher(_seg_to_rles(target_instance_seg),
                       _seg_to_rles(match_instance_seg),
                       iou_thr, return_iou, return_ioa)


def _seg_to_rles(seg):
    """Any-dimensional label map -> {label: {box, starts, runs}} over the
    raveled array (boxes in N-d coords for pair screening)."""
    seg = np.asarray(seg)
    shape = seg.shape
    flat = seg.reshape(-1)
    n = flat.size
    if n == 0:
        return {}
    w = shape[-1]
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = flat[1:] != flat[:-1]
    change[::w] = True  # row-confined runs -> exact N-d boxes below
    starts = np.nonzero(change)[0]
    ends = np.concatenate([starts[1:], [n]])
    values = flat[starts]

    fg = values != 0
    starts, ends, values = starts[fg], ends[fg], values[fg]
    out = {}
    if len(starts) == 0:
        return out

    order = np.argsort(values, kind="stable")
    s, e, v = starts[order], ends[order], values[order]
    bounds = np.nonzero(np.concatenate([[True], v[1:] != v[:-1]]))[0]
    bounds = np.concatenate([bounds, [len(v)]])
    for bi in range(len(bounds) - 1):
        i0, i1 = bounds[bi], bounds[bi + 1]
        rs, re = s[i0:i1], e[i0:i1]
        lo = np.unravel_index(rs, shape)
        hi = np.unravel_index(re - 1, shape)
        box = tuple(int(np.min(c)) for c in lo) + \
            tuple(int(np.max(c)) + 1 for c in hi)
        out[int(v[i0])] = {"box": box, "starts": rs, "runs": re - rs}
    return out


class RLEMatcher:
    """Stateful per-class forward/backward matcher
    (reference matcher.py:234-326)."""

    def __init__(self, class_id, label_divisor, merge_iou_thr=0.25,
                 merge_ioa_thr=0.25, assign_new=True, **kwargs):
        self.class_id = class_id
        self.label_divisor = label_divisor
        self.merge_iou_thr = merge_iou_thr
        self.merge_ioa_thr = merge_ioa_thr
        self.assign_new = assign_new
        self.next_label = class_id * label_divisor + 1
        self.target_rle = None

    def initialize_target(self, target_instance_rles):
        self.target_rle = target_instance_rles
        objs = list(target_instance_rles.keys())
        if objs:
            self.next_label = max(objs) + 1

    def update_target(self, instance_rles):
        self.target_rle = instance_rles

    def __call__(self, match_instance_rle, update_target=True):
        assert self.target_rle is not None, \
            "Initialize target rle before running!"

        matched_labels, all_labels, _, ioa_matrix = rle_matcher(
            self.target_rle, match_instance_rle, self.merge_iou_thr,
            return_ioa=True)

        target_labels, match_labels = all_labels
        label_matches = {ml: tl for tl, ml in zip(*matched_labels)}

        # one whole-matrix reduction instead of per-column max/argmax
        # (two small-array numpy calls per instance at 100+ inst/slice)
        if ioa_matrix is not None and ioa_matrix.size:
            ioa_max = ioa_matrix.max(axis=0)
            ioa_arg = ioa_matrix.argmax(axis=0)
        else:
            ioa_max = ioa_arg = None

        groups = {}
        for i, (ml, mattrs) in enumerate(match_instance_rle.items()):
            if ml in label_matches:
                new_label = label_matches[ml]
            elif ioa_max is not None and ioa_max[i] >= self.merge_ioa_thr:
                # false split: absorb into the most-covering target
                new_label = target_labels[int(ioa_arg[i])]
            elif self.assign_new:
                new_label = self.next_label
                self.next_label += 1
            else:
                new_label = ml
            groups.setdefault(new_label, []).append(mattrs)

        # all multi-instance labels union in ONE batched native call
        # (associative: same result as the chained pairwise merges);
        # singletons pass through untouched
        multi = [lst for lst in groups.values() if len(lst) > 1]
        merged = iter(merge_attrs_batch(multi)) if multi else None
        matched_rles = {
            label: attrs_list[0] if len(attrs_list) == 1 else next(merged)
            for label, attrs_list in groups.items()
        }

        if update_target:
            self.update_target(matched_rles)
        return matched_rles
