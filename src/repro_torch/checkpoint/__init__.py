"""Checkpoints of the port, as ``repro.checkpoint``."""
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (latest_step_dir, restore, save,
                                         save_step)

__all__ = ["ckpt", "latest_step_dir", "restore", "save", "save_step"]
