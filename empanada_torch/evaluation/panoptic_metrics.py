"""Panoptic quality from match results
(reference evaluation/panoptic_metrics.py:3-50)."""

import numpy as np

__all__ = ["panoptic_quality"]


def panoptic_quality(gt_matched, gt_unmatched, pred_matched, pred_unmatched,
                     matched_ious):
    tp_ious = matched_ious[matched_ious >= 0.5]
    tp = len(tp_ious)
    failed = int(np.count_nonzero(matched_ious < 0.5))
    fp = len(pred_unmatched) + failed
    fn = len(gt_unmatched) + failed

    if tp + fp + fn == 0:
        return 1

    sq = tp_ious.sum() / (tp + 1e-5)
    rq = tp / (tp + 0.5 * fp + 0.5 * fn)
    return sq * rq
