"""Data of the port: the synthetic LM stream, as ``repro.data``."""
from repro_torch.data.pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
