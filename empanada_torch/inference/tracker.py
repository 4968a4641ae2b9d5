"""3D instance tracking: accumulate per-slice 2D RLEs into volume RLEs.

Parity with reference inference/tracker.py:11-159, including the axis-aware
re-raveling (xy slices offset by z*H*W; xz and yz slices re-raveled into
volume order) and the JSON interchange format used by evaluation and the
napari plugin.
"""

from __future__ import annotations

import json
import math

import numpy as np

from empanada_torch.core.boxes import merge_boxes
from empanada_torch.core.ccl import _within_run_offsets
from empanada_torch.core.rle import (
    rle_decode,
    rle_encode,
    rle_to_string,
    string_to_rle,
)

__all__ = ["InstanceTracker", "to_box3d"]

_AXIS_NUMS = {"xy": 0, "xz": 1, "yz": 2}


def to_box3d(index2d, box, axis):
    h1, w1, h2, w2 = box
    if axis == "xy":
        return (index2d, h1, w1, index2d + 1, h2, w2)
    if axis == "xz":
        return (h1, index2d, w1, h2, index2d + 1, w2)
    return (h1, w1, index2d, h2, w2, index2d + 1)


class InstanceTracker:
    def __init__(self, class_id=None, label_divisor=None, shape3d=None,
                 axis="xy"):
        assert axis in _AXIS_NUMS
        self.class_id = class_id
        self.label_divisor = label_divisor
        self.shape3d = tuple(shape3d) if shape3d is not None else None
        self.axis = axis
        self.finished = False
        self.reset()

    def reset(self):
        self.instances = {}

    def update(self, instance_rles, index2d):
        assert not self.finished, "Cannot update after finish()!"
        shape3d = self.shape3d
        ignore = _AXIS_NUMS[self.axis]
        shape2d = tuple(s for i, s in enumerate(shape3d) if i != ignore)
        if not instance_rles:
            return

        # ONE vectorized re-ravel for the whole slice, split per
        # instance afterwards: at product density (100+ instances/slice)
        # the per-instance transform was ~200us of small-array overhead
        # each and dominated the backward/tracking phase at 1k^3
        labels = list(instance_rles)
        all_starts = [np.asarray(instance_rles[la]["starts"], np.int64)
                      for la in labels]
        all_runs = [np.asarray(instance_rles[la]["runs"], np.int64)
                    for la in labels]
        counts = np.array([len(s) for s in all_starts], dtype=np.int64)
        starts2d = np.concatenate(all_starts) if len(labels) > 1 \
            else all_starts[0]
        runs2d = np.concatenate(all_runs) if len(labels) > 1 \
            else all_runs[0]

        if self.axis == "xy":
            starts = starts2d + index2d * math.prod(shape2d)
            runs = runs2d
            out_counts = counts
        elif self.axis == "xz":
            # 2D rows are volume-z rows; x runs stay contiguous, but
            # a canonical RLE may merge runs across 2D row (x-edge)
            # boundaries — split those first or the tail would spill
            # into the wrong volume row after re-raveling
            w2d = shape2d[1]
            ends2d = starts2d + runs2d
            n_rows = (ends2d - 1) // w2d - starts2d // w2d
            if n_rows.any():
                reps = n_rows + 1
                base = np.repeat(starts2d, reps)
                offs = _within_run_offsets(reps)
                row0 = np.repeat(starts2d // w2d, reps)
                rr = row0 + offs
                split_starts = np.maximum(base, rr * w2d)
                split_runs = np.minimum(np.repeat(ends2d, reps),
                                        (rr + 1) * w2d) - split_starts
                seg = np.repeat(np.arange(len(labels)), counts)
                out_counts = np.bincount(
                    seg, weights=reps,
                    minlength=len(labels)).astype(np.int64)
                starts2d, runs2d = split_starts, split_runs
            else:
                out_counts = counts
            # 2D (z, x) -> 3D (z, y=index2d, x) raveling in closed form:
            # z*H*W + index2d*W + x  ==  flat + (flat//W)*(H-1)*W + y*W
            # (one div + fused mul-adds; the generic unravel_index +
            # ravel_multi_index pair allocated a full_like constant row
            # and three temporaries per slice — measurable at product
            # density where this runs per slice on ~10^5-run buffers)
            W3 = shape3d[2]
            starts = starts2d + (starts2d // W3) * (shape3d[1] - 1) * W3 \
                + index2d * W3
            runs = runs2d
        else:  # yz: runs break per voxel in volume order
            flat2d = rle_decode(starts2d, runs2d)
            # 2D (z, y) -> 3D (z, y, x=index2d): (z*H + y)*W + x with
            # flat2d == z*H + y, so one multiply-add — no unravel at all
            starts = flat2d * shape3d[2] + index2d
            runs = np.ones_like(starts)
            seg = np.repeat(np.arange(len(labels)), counts)
            out_counts = np.bincount(
                seg, weights=runs2d, minlength=len(labels)).astype(np.int64)

        offsets = np.concatenate([[0], np.cumsum(out_counts)])
        for i, label in enumerate(labels):
            box = to_box3d(index2d, instance_rles[label]["box"], self.axis)
            lo, hi = offsets[i], offsets[i + 1]
            if label not in self.instances:
                self.instances[label] = {
                    "box": box,
                    "starts": [starts[lo:hi]],
                    "runs": [runs[lo:hi]],
                }
            else:
                inst = self.instances[label]
                inst["box"] = merge_boxes(box, inst["box"])
                inst["starts"].append(starts[lo:hi])
                inst["runs"].append(runs[lo:hi])

    def finish(self):
        for instance_id, attrs in self.instances.items():
            if not isinstance(attrs["starts"], list):
                continue
            # backward matching updates slices in DECREASING index order
            # and each per-slice segment is internally ascending, so the
            # reversed concatenation is already globally sorted for the
            # xy axis (slice index is the high raveling digit) — an O(n)
            # check there replaces the O(n log n) sort. Forward-order
            # flows (e.g. direct update loops) sort under the other
            # orientation; anything else falls through to the sort.
            def _sorted(a):
                return len(a) < 2 or bool(np.all(a[1:] >= a[:-1]))

            # the reversed probe can only succeed when the slice index is
            # the high raveling digit (xy axis); probing it on xz/yz just
            # buys an extra O(n) concat per instance on the product path
            probes = ((slice(None, None, -1), slice(None))
                      if self.axis == "xy" else (slice(None),))
            order_used = None
            for sl in probes:
                starts = np.concatenate(attrs["starts"][sl])
                if _sorted(starts):
                    order_used = sl
                    break
            if self.axis == "yz":
                # voxels were not run length encoded; sort and re-encode
                if order_used is None:
                    starts = np.sort(starts, kind="stable")
                starts, runs = rle_encode(starts)
            else:
                if order_used is not None:
                    runs = np.concatenate(attrs["runs"][order_used])
                else:
                    # `starts` already holds the forward concatenation
                    # from the loop's final probe — don't rebuild it
                    runs = np.concatenate(attrs["runs"])
                    order = np.argsort(starts, kind="stable")
                    starts, runs = starts[order], runs[order]
            attrs["starts"] = starts
            attrs["runs"] = runs
        self.finished = True

    # --- JSON interchange (same schema as the reference) -----------------
    def write_to_json(self, savepath):
        if not self.finished:
            self.finish()

        save_dict = {
            "class_id": self.class_id,
            "label_divisor": self.label_divisor,
            "shape3d": list(self.shape3d),
            "axis": self.axis,
            "finished": True,
            "instances": {},
        }
        for k, attrs in self.instances.items():
            save_dict["instances"][str(k)] = {
                "box": [int(b) for b in attrs["box"]],
                "rle": rle_to_string(attrs["starts"], attrs["runs"]),
            }
        with open(savepath, "w") as f:
            json.dump(save_dict, f, indent=2)

    def load_from_json(self, fpath):
        with open(fpath) as f:
            load_dict = json.load(f)
        self.class_id = load_dict["class_id"]
        self.label_divisor = load_dict["label_divisor"]
        self.shape3d = tuple(load_dict["shape3d"])
        self.axis = load_dict["axis"]
        self.finished = load_dict.get("finished", True)
        self.instances = {}
        for k, attrs in load_dict["instances"].items():
            starts, runs = string_to_rle(attrs["rle"])
            self.instances[int(k) if str(k).isdigit() else k] = {
                "box": tuple(attrs["box"]),
                "starts": starts,
                "runs": runs,
            }
