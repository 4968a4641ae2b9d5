"""Panoptic training dataset: label_divisor-encoded masks decoded into
semantic and thing segmentations."""

from __future__ import annotations

import numpy as np

from empanada_torch.data._base import BaseDataset
from empanada_torch.data.utils.target_creation import heatmap_and_offsets

__all__ = ["PanopticDataset"]


class PanopticDataset(BaseDataset):
    """Emits {image, sem, ctr_hmp, offsets}: sem is the class id where
    the mask's quotient is a known label, the centers come from the
    thing classes only."""

    def __init__(self, data_dir, labels, thing_list, label_divisor,
                 transforms=None, heatmap_sigma=6, weight_gamma=0.3):
        super().__init__(data_dir, transforms, weight_gamma)
        if len(labels) <= 1:
            raise ValueError(
                "PanopticDataset needs at least two label classes; for a "
                "single instance class use SingleClassInstanceDataset.")
        if any(l <= 0 for l in labels):
            raise ValueError("label class ids must be strictly positive ints")
        self.labels = labels
        self.thing_list = thing_list
        self.label_divisor = label_divisor
        self.heatmap_sigma = heatmap_sigma

    def __getitem__(self, idx):
        image, mask = self.load_pair(idx)
        if self.transforms is not None:
            output = self.transforms(image=image, mask=mask)
        else:
            output = {"image": image, "mask": mask}
        mask = output["mask"]
        class_of = mask // self.label_divisor
        known = np.isin(class_of, self.labels)
        sem_seg = np.where(known, class_of, 0)
        is_thing = known & np.isin(class_of, self.thing_list)
        thing_seg = np.where(is_thing, mask, 0)
        heatmap, offsets = heatmap_and_offsets(thing_seg, self.heatmap_sigma)
        output["sem"] = sem_seg.astype(np.int32)
        output["ctr_hmp"] = heatmap
        output["offsets"] = offsets
        output["fname"] = self.impaths[idx]
        return output
