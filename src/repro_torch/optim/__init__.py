"""Optimizer of the port: AdamW, as ``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, apply_updates,
                                     clip_by_global_norm, cosine_lr,
                                     global_norm, init_state)

__all__ = ["AdamWConfig", "AdamWState", "apply_updates",
           "clip_by_global_norm", "cosine_lr", "global_norm", "init_state"]
