"""Base dataset: dir-of-subdirs image/mask pairs, dataset addition and
inverse-count sampling weights.

Layout: ``<data_dir>/<subdir>/images/*`` and ``<data_dir>/<subdir>/
masks/*``, paired by sorted name. Each subdirectory's examples weigh
normalize((1 / count) ** gamma), so small sources are not drowned out.
Examples are dicts of numpy arrays; the loader (``data/loader.py``)
collates them into tensors.
"""

from __future__ import annotations

import copy
import os
from glob import glob

import numpy as np

from empanada_torch.data.image_files import read_image, read_mask

__all__ = ["BaseDataset", "read_image", "read_mask"]


class BaseDataset:
    """data_dir -> source subdirs -> images/ masks/ pairs."""

    def __init__(self, data_dir, transforms=None, weight_gamma=None):
        self.data_dir = data_dir
        self.subdirs = sorted(
            sd for sd in os.listdir(data_dir)
            if os.path.isdir(os.path.join(data_dir, sd)))
        self.impaths_dict = {}
        self.mskpaths_dict = {}
        for sd in self.subdirs:
            self.impaths_dict[sd] = sorted(
                glob(os.path.join(data_dir, sd, "images", "*")))
            self.mskpaths_dict[sd] = sorted(
                glob(os.path.join(data_dir, sd, "masks", "*")))
        self.weight_gamma = weight_gamma
        self._unpack()
        print(f"Found {len(self.subdirs)} image subdirectories "
              f"with {len(self.impaths)} images.")
        self.transforms = transforms

    def _unpack(self):
        self.weights = None if self.weight_gamma is None else \
            self._example_weights(self.impaths_dict, gamma=self.weight_gamma)
        self.impaths = [p for ps in self.impaths_dict.values() for p in ps]
        self.mskpaths = [p for ps in self.mskpaths_dict.values() for p in ps]

    def __len__(self):
        return len(self.impaths)

    def __add__(self, other):
        """Merge two datasets; a subdirectory present in both pools its
        examples, and the weights are recomputed. The transforms are
        shared, not copied."""
        merged = copy.copy(self)
        merged.impaths_dict = {k: list(v) for k, v in
                               self.impaths_dict.items()}
        merged.mskpaths_dict = {k: list(v) for k, v in
                                self.mskpaths_dict.items()}
        for sd in other.impaths_dict:
            merged.impaths_dict.setdefault(sd, []).extend(
                other.impaths_dict[sd])
            merged.mskpaths_dict.setdefault(sd, []).extend(
                other.mskpaths_dict[sd])
        merged._unpack()
        return merged

    @staticmethod
    def _example_weights(paths_dict, gamma=0.3):
        counts = np.array([len(ps) for ps in paths_dict.values()],
                          dtype=np.float64)
        weights = (1.0 / counts) ** gamma
        weights /= weights.sum()
        return np.concatenate([np.full(int(c), w)
                               for w, c in zip(weights, counts)])

    def load_pair(self, idx):
        image = read_image(self.impaths[idx])
        mask = read_mask(self.mskpaths[idx])
        if image.ndim == 2:
            image = image[..., None]
        return image, mask

    def __getitem__(self, idx):
        raise NotImplementedError
