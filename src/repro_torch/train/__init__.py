"""Training of the port, as ``repro.train``."""
from repro_torch.train.train_step import loss_and_grads, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["loss_and_grads", "make_train_step", "Trainer", "TrainerConfig"]
