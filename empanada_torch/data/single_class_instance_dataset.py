"""Single-instance-class dataset: the mask is an instance segmentation
of one class; sem = mask > 0."""

from __future__ import annotations

import numpy as np

from empanada_torch.data._base import BaseDataset
from empanada_torch.data.utils.target_creation import heatmap_and_offsets

__all__ = ["SingleClassInstanceDataset"]


class SingleClassInstanceDataset(BaseDataset):
    def __init__(self, data_dir, transforms=None, heatmap_sigma=6,
                 weight_gamma=0.3, **kwargs):
        super().__init__(data_dir, transforms, weight_gamma)
        self.heatmap_sigma = heatmap_sigma

    def __getitem__(self, idx):
        image, mask = self.load_pair(idx)
        if self.transforms is not None:
            output = self.transforms(image=image, mask=mask)
        else:
            output = {"image": image, "mask": mask}
        mask = output["mask"]
        heatmap, offsets = heatmap_and_offsets(mask, self.heatmap_sigma)
        output["ctr_hmp"] = heatmap
        output["offsets"] = offsets
        output["sem"] = (mask > 0).astype(np.float32)
        output["fname"] = self.impaths[idx]
        return output
