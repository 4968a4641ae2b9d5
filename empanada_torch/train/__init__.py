"""Training: the trainer, optimizers and schedules, checkpoints."""

from empanada_torch.train.checkpoint import (
    load_checkpoint,
    restore_state,
    save_checkpoint,
)
from empanada_torch.train.optim import configure_optimizer, create_lr_schedule
from empanada_torch.train.trainer import Trainer

__all__ = ["Trainer", "configure_optimizer", "create_lr_schedule",
           "load_checkpoint", "restore_state", "save_checkpoint"]
