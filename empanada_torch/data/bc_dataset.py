"""Boundary-contour dataset: each example gives the image, the binary
foreground ``sem`` and the binary instance contour ``cnt``."""

from __future__ import annotations

import numpy as np

from empanada_torch.data._base import BaseDataset
from empanada_torch.data.utils.target_creation import seg_to_instance_bd

__all__ = ["BCDataset"]


class BCDataset(BaseDataset):
    def __init__(self, data_dir, transforms=None, weight_gamma=0.3,
                 **kwargs):
        super().__init__(data_dir, transforms, weight_gamma)

    def __getitem__(self, idx):
        image, mask = self.load_pair(idx)
        if self.transforms is not None:
            output = self.transforms(image=image, mask=mask)
        else:
            output = {"image": image, "mask": mask}
        mask = output.pop("mask")
        contours = seg_to_instance_bd(mask[None])[0]
        output["sem"] = (mask > 0).astype(np.float32)
        output["cnt"] = (contours > 0).astype(np.float32)
        output["fname"] = self.impaths[idx]
        return output
