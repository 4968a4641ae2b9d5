from empanada_torch.data.utils.target_creation import heatmap_and_offsets
from empanada_torch.data.utils.transforms import (
    create_augmentations,
    factor_pad_numpy,
    resize_by_factor,
)

__all__ = ["heatmap_and_offsets", "create_augmentations", "factor_pad_numpy",
           "resize_by_factor"]
