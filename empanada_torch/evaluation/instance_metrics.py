"""Instance detection metrics over Hungarian-match results
(reference evaluation/instance_metrics.py:3-224).

All take the match decomposition (matched/unmatched labels + matched IoUs);
matches below iou_thr count as both a FP and a FN. Empty masks score 1 by
convention.
"""

import numpy as np

__all__ = ["f1", "ap", "precision", "recall",
           "f1_50", "f1_75", "precision_50", "precision_75",
           "recall_50", "recall_75"]


def _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr):
    tp = int(np.count_nonzero(matched_ious >= iou_thr))
    failed = int(np.count_nonzero(matched_ious < iou_thr))
    fp = len(pred_unmatched) + failed
    fn = len(gt_unmatched) + failed
    return tp, fp, fn


def f1(gt_matched, gt_unmatched, pred_matched, pred_unmatched,
       matched_ious, iou_thr=0.5):
    tp, fp, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp + fn == 0:
        return 1
    return tp / (tp + 0.5 * fp + 0.5 * fn)


def ap(gt_matched, gt_unmatched, pred_matched, pred_unmatched,
       matched_ious, iou_thr=0.5):
    tp, fp, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp + fn == 0:
        return 1
    return tp / (tp + fp + fn)


def precision(gt_matched, gt_unmatched, pred_matched, pred_unmatched,
              matched_ious, iou_thr=0.5):
    tp, fp, _ = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fp == 0:
        return 1
    return tp / (tp + fp)


def recall(gt_matched, gt_unmatched, pred_matched, pred_unmatched,
           matched_ious, iou_thr=0.5):
    tp, _, fn = _counts(gt_unmatched, pred_unmatched, matched_ious, iou_thr)
    if tp + fn == 0:
        return 1
    return tp / (tp + fn)


def f1_50(**kwargs):
    return f1(**kwargs, iou_thr=0.5)


def f1_75(**kwargs):
    return f1(**kwargs, iou_thr=0.75)


def precision_50(**kwargs):
    return precision(**kwargs, iou_thr=0.5)


def precision_75(**kwargs):
    return precision(**kwargs, iou_thr=0.75)


def recall_50(**kwargs):
    return recall(**kwargs, iou_thr=0.5)


def recall_75(**kwargs):
    return recall(**kwargs, iou_thr=0.75)
