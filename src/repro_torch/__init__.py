"""repro_torch: the PyTorch/CUDA port of the SISA reproduction.

It grows beside the JAX package ``repro`` (the reference) slice by
slice and imports nothing of it.  Entry points take ``device=None``,
which means the CUDA card; with no card they raise instead of falling
back to the CPU, and tests ask for ``device="cpu"`` explicitly.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and
    none is present (the port never falls back to the CPU silently)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain path on the CPU")
    return dev
