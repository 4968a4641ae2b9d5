"""Slice views over 3D volumes for inference
(reference data/volume_dataset.py:8-54).

Accepts numpy arrays, memmaps, or any chunked store with .shape and
slice getitem. Optional log2
downscaling before transforms, matching the reference's cheap low-res +
PointRend-upsample path (reference pdl_inference3d.py:50-51).
"""

from __future__ import annotations

import math

import numpy as np

from empanada_torch.data.utils.transforms import resize_by_factor

__all__ = ["VolumeDataset"]


def take_slice(array, idx, axis):
    slices = [slice(None)] * 3
    slices[axis] = idx
    return np.asarray(array[tuple(slices)])


class VolumeDataset:
    def __init__(self, array, axis=0, tfs=None, scale=1):
        if not math.log2(scale).is_integer():
            raise ValueError(f"Image rescaling must be log base 2, got {scale}")
        self.array = array
        self.axis = axis
        self.tfs = tfs
        self.scale = scale

    def __len__(self):
        return self.array.shape[self.axis]

    def __getitem__(self, idx):
        image = take_slice(self.array, idx, self.axis)
        h, w = image.shape
        image = resize_by_factor(image, self.scale)
        assert image.shape[0] * self.scale >= h
        assert image.shape[1] * self.scale >= w

        if self.tfs is not None:
            image = self.tfs(image=image)["image"]
        return {"index": idx, "image": image, "size": (h, w)}
