"""Semantic-segmentation metric over (n, 2) [start, run] range arrays
(capability of reference evaluation/semantic_metrics.py:4-27)."""

from empanada_torch.core.rle import rle_iou

__all__ = ["iou"]


def iou(gt_rle, pred_rle):
    """IoU of two semantic RLEs; empty-vs-empty scores 1 by convention,
    empty-vs-nonempty scores 0."""
    n_gt, n_pred = len(gt_rle), len(pred_rle)
    if n_gt == 0 or n_pred == 0:
        return 1 if n_gt == n_pred else 0
    return rle_iou(gt_rle[:, 0], gt_rle[:, 1],
                   pred_rle[:, 0], pred_rle[:, 1])
