from empanada_torch.data.volume_dataset import VolumeDataset

__all__ = ["VolumeDataset"]
