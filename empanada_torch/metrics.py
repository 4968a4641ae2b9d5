"""Train-time metrics.

IoU runs on the tensors' device (NCHW logits, one host read per call);
PQ / F1 decode label_divisor panoptic ids and match instances on the
host (the RLE matcher of ``inference/matcher.py``). The meters and
``ComposeMetrics`` keep the JAX package's streaming semantics
(bias-corrected EMA; reset-on-print display history).
"""

from __future__ import annotations

import numpy as np
import torch

from empanada_torch.inference.matcher import fast_matcher

__all__ = [
    "EMAMeter",
    "AverageMeter",
    "IoU",
    "PQ",
    "F1",
    "ComposeMetrics",
    "METRICS",
    "create_metric",
]


class EMAMeter:
    """Bias-corrected exponential moving average."""

    def __init__(self, momentum=0.98):
        self.mom = momentum
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val):
        self.val = val
        self.sum = self.sum * self.mom + val * (1 - self.mom)
        self.count += 1
        self.avg = self.sum / (1 - self.mom ** self.count)


class AverageMeter:
    """Plain running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val):
        self.val = val
        self.sum = self.sum + val
        self.count += 1
        self.avg = self.sum / self.count


class _BaseMetric:
    def __init__(self, meter, labels):
        self.meters = {l: meter() for l in labels}
        self.labels = labels

    def update(self, value_dict):
        for l, v in value_dict.items():
            self.meters[l].update(v)

    def reset(self):
        for l in self.labels:
            self.meters[l].reset()

    def average(self):
        return {l: meter.avg for l, meter in self.meters.items()}


class IoU(_BaseMetric):
    """Soft->hard per-class IoU of NCHW logits against (N, H, W)
    targets."""

    def __init__(self, meter, labels, output_key="sem_logits",
                 target_key="sem", **kwargs):
        super().__init__(meter, labels)
        self.output_key = output_key
        self.target_key = target_key

    def calculate(self, output, target):
        logits = output[self.output_key].float()
        tgt = target[self.target_key].to(logits.device)
        n_classes = logits.shape[1]
        if n_classes > 1:
            pred = torch.argmax(logits, dim=1)
            ious = []
            for c in range(n_classes):
                p = pred == c
                t = tgt == c
                intersect = (p & t).sum()
                union = p.sum() + t.sum() - intersect
                ious.append((intersect + 1e-5) / (union + 1e-5))
            ious = torch.stack(ious).cpu().tolist()
            return {l: ious[l] for l in self.labels}
        pred = logits[:, 0] > 0  # sigmoid(x) > 0.5 <=> x > 0
        t = tgt > 0
        intersect = (pred & t).sum()
        union = pred.sum() + t.sum() - intersect
        iou = (intersect + 1e-5) / (union + 1e-5)
        return {self.labels[0]: float(iou)}


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _to_class_seg(pan_seg, label, label_divisor):
    min_id = label * label_divisor
    max_id = min_id + label_divisor
    out = np.array(pan_seg)
    out[(out < min_id) | (out >= max_id)] = 0
    return out


def _detection_counts(output, target, labels, label_divisor, iou_thr,
                      output_key, target_key):
    """(tp, fp, fn, matched_iou_sum) per class via Hungarian matching."""
    out = _host(output[output_key]).squeeze().astype(np.int64)
    tgt = _host(target[target_key]).squeeze().astype(np.int64)

    results = {}
    for label in labels:
        pred_seg = _to_class_seg(out, label, label_divisor)
        tgt_seg = _to_class_seg(tgt, label, label_divisor)
        matched_labels, all_labels, matched_ious = fast_matcher(
            tgt_seg, pred_seg, iou_thr=iou_thr)
        tp = len(matched_labels[0])
        fn = len(np.setdiff1d(all_labels[0], matched_labels[0]))
        fp = len(np.setdiff1d(all_labels[1], matched_labels[1]))
        results[label] = (tp, fp, fn, float(np.sum(matched_ious)))
    return results


class PQ(_BaseMetric):
    """Panoptic quality on label_divisor-encoded maps."""

    def __init__(self, meter, labels, label_divisor, output_key="pan_seg",
                 target_key="pan_seg", **kwargs):
        super().__init__(meter, labels)
        self.label_divisor = label_divisor
        self.output_key = output_key
        self.target_key = target_key

    def calculate(self, output, target):
        counts = _detection_counts(
            output, target, self.labels, self.label_divisor, 0.5,
            self.output_key, self.target_key)
        per_class = {}
        for label, (tp, fp, fn, iou_sum) in counts.items():
            if tp + fp + fn == 0:
                per_class[label] = 1.0  # PQ of empty masks is 1 by convention
                continue
            sq = iou_sum / (tp + 1e-5)
            rq = tp / (tp + 0.5 * fp + 0.5 * fn)
            per_class[label] = sq * rq
        return per_class


class F1(_BaseMetric):
    """Instance detection F1 at an IoU threshold."""

    def __init__(self, meter, labels, label_divisor, iou_thr=0.5,
                 output_key="pan_seg", target_key="pan_seg", **kwargs):
        super().__init__(meter, labels)
        self.label_divisor = label_divisor
        self.iou_thr = iou_thr
        self.output_key = output_key
        self.target_key = target_key

    def calculate(self, output, target):
        counts = _detection_counts(
            output, target, self.labels, self.label_divisor, self.iou_thr,
            self.output_key, self.target_key)
        per_class = {}
        for label, (tp, fp, fn, _) in counts.items():
            if tp + fp + fn == 0:
                per_class[label] = 1.0
            else:
                per_class[label] = tp / (tp + 0.5 * fn + 0.5 * fp)
        return per_class


class ComposeMetrics:
    """Evaluate/display/history bundle."""

    def __init__(self, metrics_dict, class_names, reset_on_print=True):
        self.metrics_dict = metrics_dict
        self.class_names = class_names
        self.reset_on_print = reset_on_print
        self.history = {}

    def evaluate(self, output, target):
        for metric in self.metrics_dict.values():
            metric.update(metric.calculate(output, target))

    def display(self):
        for metric_name, metric in self.metrics_dict.items():
            avg_values = metric.average()
            for l, v in avg_values.items():
                name = f"{self.class_names[l]}_{metric_name}"
                self.history.setdefault(name, []).append(float(v))
                print(name, float(v))
            if self.reset_on_print:
                metric.reset()


METRICS = {"IoU": IoU, "PQ": PQ, "F1": F1}


def create_metric(name, meter, labels, **kwargs):
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; choices: {sorted(METRICS)}")
    meter_cls = {"EMAMeter": EMAMeter, "AverageMeter": AverageMeter}.get(
        meter, meter)
    return METRICS[name](meter_cls, labels, **kwargs)
