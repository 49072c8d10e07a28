"""Weights from the JAX package into the port's parameter tree.

:func:`params_from_jax` takes the reference's parameter pytree with
every leaf already converted to numpy (``jax.tree.map(np.asarray,
params)`` on the caller's side — this module imports no JAX) and
returns the port's tree: the scanned layer groups
(``repro/models/transformer.py:59-98``) unstacked into one dict per
layer, in the order the reference's scan runs them, so both packages
compute the same function on the same weights.  :func:`cache_from_jax`
does the same for a dense cache: the reference's per-group cache
pytrees (``repro/models/transformer.py:init_cache``) become the port's
per-class stacks (``repro_torch.models.transformer``'s module doc:
``{"k","v"[,"k_s","v_s"]}: (L, B, cap, Hkv, hd)`` for global layers,
``"w"``-prefixed for local ones, ``{"h","conv"}`` and
``{"state","shift"}`` for the recurrent ones), and
:func:`pools_from_jax` for the paged engine's pools and state slabs.
Float32 leaves (the recurrent gates, decays and states) stay float32
in a model of another dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (cache_layout, check_supported,
                                           stack_name)


def _tensor(x, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":        # ml_dtypes: no torch.from_numpy
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # a writable copy
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack_layers(groups, cfg: ModelConfig):
    """One entry per layer, in the order the reference's scan runs
    them: ``(group pytree, block name, repeat index)``."""
    return [(group, f"b{i}", r)
            for group, (pattern, n_reps) in zip(groups, cfg.layer_groups())
            for r in range(n_reps) for i in range(len(pattern))]


def cache_from_jax(caches, cfg: ModelConfig, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The reference's dense cache (a list of per-group pytrees, leaves
    already numpy) as the port's per-class layer stacks."""
    check_supported(cfg)
    dev = resolve_device(device)
    stacks: Dict[str, list] = {}
    for (group, b, r), (tag, _) in zip(_unstack_layers(caches, cfg),
                                       cache_layout(cfg)):
        stacks.setdefault(tag, []).append(
            {name: np.asarray(x)[r] for name, x in group[b].items()})
    return {stack_name(tag, name): _tensor(
                np.stack([layer[name] for layer in layers]), dev)
            for tag, layers in stacks.items() for name in layers[0]}


def pools_from_jax(pools, cfg: ModelConfig, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The reference's paged pools (per-group pytrees whose leaves,
    already numpy, are named ``"pk","pv"[,"pk_s","pv_s"]`` for global
    layers, ``"lk","lv"`` for local ones, and ``"h","conv"`` /
    ``"state","shift"`` for the recurrent layers' slot slabs) as the
    port's pool stacks under the same names, each layer at its index in
    its class."""
    check_supported(cfg)
    dev = resolve_device(device)
    stacks: Dict[str, list] = {}
    for group, b, r in _unstack_layers(pools, cfg):
        for name, x in group[b].items():
            stacks.setdefault(name, []).append(np.asarray(x)[r])
    return {name: _tensor(np.stack(xs), dev) for name, xs in stacks.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """The reference's (numpy-leaved) params as the port's tree, with
    the untied ``lm_head`` and a stub frontend's ``frontend_proj``
    (``{"w","b"}``) where the reference's tree has them."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = [_map(group[b], lambda x, r=r: _tensor(np.asarray(x)[r], dev))
              for group, b, r in _unstack_layers(tree["groups"], cfg)]
    out = {"embed": _map(tree["embed"], lambda x: _tensor(x, dev)),
           "final_norm": _map(tree["final_norm"], lambda x: _tensor(x, dev)),
           "layers": layers}
    for name in ("lm_head", "frontend_proj"):
        if name in tree:
            out[name] = _map(tree[name], lambda x: _tensor(x, dev))
    return out
