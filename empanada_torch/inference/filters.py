"""In-place tracker instance filters (reference inference/filters.py:9-44)."""

from __future__ import annotations

import numpy as np

__all__ = ["remove_small_objects", "remove_pancakes"]


def remove_small_objects(tracker, min_size=64):
    """Drop instances with fewer than min_size voxels."""
    for label in list(tracker.instances.keys()):
        if int(np.sum(tracker.instances[label]["runs"])) < min_size:
            del tracker.instances[label]


def remove_pancakes(tracker, min_span=4):
    """Drop instances whose bounding box spans < min_span along any axis."""
    for label in list(tracker.instances.keys()):
        box = tracker.instances[label]["box"]
        ndim = len(box) // 2
        spans = [box[i + ndim] - box[i] for i in range(ndim)]
        if min(spans) < min_span:
            del tracker.instances[label]
