"""Offline 3D evaluation of tracker RLE JSONs
(reference evaluation/evaluator.py:23-140)."""

from __future__ import annotations

import json

import numpy as np

from empanada_torch.core.rle import merge_rles, string_to_rle
from empanada_torch.inference.matcher import rle_matcher

__all__ = ["Evaluator", "default_evaluator"]


def _merge_encodings_for_semantic(encodings):
    """Union of all instance RLEs -> (n, 2) [start, run]
    (reference evaluator.py:9-25)."""
    if len(encodings) >= 1:
        runs = np.concatenate([
            np.stack(string_to_rle(enc), axis=1) for enc in encodings
        ])
        merged = np.stack(merge_rles(runs[:, 0], runs[:, 1]), axis=1)
        return merged
    return np.zeros((0, 2), np.int64)


class Evaluator:
    """Compares GT/pred tracker JSONs: semantic metrics on the merged
    foreground RLE; instance/panoptic metrics on Hungarian-matched
    instances."""

    def __init__(self, semantic_metrics=None, instance_metrics=None,
                 panoptic_metrics=None):
        self.semantic_metrics = semantic_metrics
        self.instance_metrics = instance_metrics
        self.panoptic_metrics = panoptic_metrics

    def __call__(self, gt_json_fpath, pred_json_fpath,
                 return_instances=False):
        with open(gt_json_fpath) as f:
            gt_json = json.load(f)
        with open(pred_json_fpath) as f:
            pred_json = json.load(f)

        assert gt_json["class_id"] == pred_json["class_id"], \
            "Prediction and ground truth classes must match!"

        semantic_results = {}
        instance_results = {}
        panoptic_results = {}
        instances_dict = {}

        if self.semantic_metrics is not None:
            gt_sem = _merge_encodings_for_semantic(
                [a["rle"] for a in gt_json["instances"].values()])
            pred_sem = _merge_encodings_for_semantic(
                [a["rle"] for a in pred_json["instances"].values()])
            semantic_results = {
                name: func(gt_sem, pred_sem)
                for name, func in self.semantic_metrics.items()
            }

        if self.instance_metrics is not None \
                or self.panoptic_metrics is not None:
            matched_labels, all_labels, matched_ious = rle_matcher(
                gt_json["instances"], pred_json["instances"])
            gt_labels, gt_matched = all_labels[0], matched_labels[0]
            pred_labels, pred_matched = all_labels[1], matched_labels[1]
            gt_unmatched = np.setdiff1d(gt_labels, gt_matched)
            pred_unmatched = np.setdiff1d(pred_labels, pred_matched)

            kwargs = {
                "gt_matched": gt_matched,
                "pred_matched": pred_matched,
                "gt_unmatched": gt_unmatched,
                "pred_unmatched": pred_unmatched,
                "matched_ious": matched_ious,
            }
            instances_dict = kwargs
            if self.instance_metrics is not None:
                instance_results = {
                    name: func(**kwargs)
                    for name, func in self.instance_metrics.items()
                }
            if self.panoptic_metrics is not None:
                panoptic_results = {
                    name: func(**kwargs)
                    for name, func in self.panoptic_metrics.items()
                }

        results = {**semantic_results, **instance_results,
                   **panoptic_results}
        if return_instances:
            return results, instances_dict
        return results


def default_evaluator():
    """The metric set used by the reference evaluate3d scripts
    (reference projects/mitonet/scripts/evaluate3d.py)."""
    from empanada_torch.evaluation import (
        f1_50, f1_75, iou, panoptic_quality,
        precision_50, precision_75, recall_50, recall_75,
    )

    return Evaluator(
        semantic_metrics={"iou": iou},
        instance_metrics={
            "f1_50": f1_50, "f1_75": f1_75,
            "precision_50": precision_50, "precision_75": precision_75,
            "recall_50": recall_50, "recall_75": recall_75,
        },
        panoptic_metrics={"pq": panoptic_quality},
    )
