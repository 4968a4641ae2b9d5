"""Datasets, loader, sampler, transforms and target creation."""

from empanada_torch.data._base import BaseDataset
from empanada_torch.data.loader import DataLoader, collate
from empanada_torch.data.panoptic_dataset import PanopticDataset
from empanada_torch.data.single_class_instance_dataset import (
    SingleClassInstanceDataset,
)
from empanada_torch.data.volume_dataset import VolumeDataset

__all__ = ["BaseDataset", "DataLoader", "collate", "PanopticDataset",
           "SingleClassInstanceDataset", "VolumeDataset", "DATASETS",
           "create_dataset"]


class BCDataset:
    """The boundary-contour dataset waits for the BC family."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "BCDataset is not ported yet: it comes with the "
            "boundary-contour (BC) model family")


DATASETS = {
    "PanopticDataset": PanopticDataset,
    "SingleClassInstanceDataset": SingleClassInstanceDataset,
    "BCDataset": BCDataset,
}


def create_dataset(name, *args, **kwargs):
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; choices: {sorted(DATASETS)}")
    return DATASETS[name](*args, **kwargs)
