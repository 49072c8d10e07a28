"""Gradient compression with error feedback (the port of
``repro/distributed/compression.py``).

Compressing the cross-replica gradient reduction to bf16 (or int8)
halves (quarters) its bytes.  Error feedback keeps a float32 residual so
the compression bias does not accumulate across steps:

    c_t  = Q(g_t + e_{t-1})
    e_t  = (g_t + e_{t-1}) - c_t

A gradient transform on trees of tensors (nested dicts and lists), off
by default; the train step's ``grad_compression="bf16"`` is the plain
round trip without the residual, as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.optim.adamw import tree_map

PyTree = Any


def init_error_state(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "int8":
        # symmetric per-tensor scale
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        return torch.clamp(torch.round(x / scale), -127, 127) * scale
    raise ValueError(kind)


def compress_grads(grads: PyTree, err: Optional[PyTree], kind: str = "bf16"
                   ) -> Tuple[PyTree, PyTree]:
    """``(compressed grads, new error state)``, both float32."""
    if err is None:
        err = init_error_state(grads)
    summed = tree_map(lambda g, e: g.float() + e, grads, err)
    comp = tree_map(lambda s: _quantize(s, kind), summed)
    return comp, tree_map(lambda s, c: s - c, summed, comp)
