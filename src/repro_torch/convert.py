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
``{"state","shift"}`` for the recurrent ones, and an enc-dec decoder's
per-layer ``{"self", "cross"}`` caches as the self stacks beside the
cross stacks ``"xk","xv"``), and :func:`pools_from_jax` for the paged
engine's pools (an enc-dec model's cross pools ``"ck","cv"`` among
them) and state slabs.  An enc-dec model's encoder (one
scanned ``(BIDIR,)`` group) unstacks into ``params["encoder"]
["layers"]``.  Float32 leaves (the recurrent gates, decays and states)
stay float32 in a model of another dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import BIDIR, ModelConfig
from repro_torch.models.transformer import (cache_layout, check_supported,
                                           CROSS_STACKS, stack_name)


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


def _unstack_layers(groups, cfg: ModelConfig, layer_groups=None):
    """One entry per layer, in the order the reference's scan runs
    them: ``(group pytree, block name, repeat index)``; the decoder's
    groups unless ``layer_groups`` says otherwise."""
    return [(group, f"b{i}", r)
            for group, (pattern, n_reps) in zip(
                groups, layer_groups or cfg.layer_groups())
            for r in range(n_reps) for i in range(len(pattern))]


def cache_from_jax(caches, cfg: ModelConfig, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The reference's dense cache (a list of per-group pytrees, leaves
    already numpy) as the port's per-class layer stacks."""
    check_supported(cfg)
    dev = resolve_device(device)
    stacks: Dict[str, list] = {}
    cross: list = []
    for (group, b, r), (tag, _) in zip(_unstack_layers(caches, cfg),
                                       cache_layout(cfg)):
        layer = group[b]
        if cfg.enc_dec:
            cross.append({stack: np.asarray(layer["cross"][name])[r]
                          for stack, name in zip(CROSS_STACKS, "kv")})
            layer = layer["self"]
        stacks.setdefault(tag, []).append(
            {name: np.asarray(x)[r] for name, x in layer.items()})
    out = {stack_name(tag, name): _tensor(
               np.stack([layer[name] for layer in layers]), dev)
           for tag, layers in stacks.items() for name in layers[0]}
    out.update({name: _tensor(np.stack([c[name] for c in cross]), dev)
                for name in CROSS_STACKS if cross})
    return out


def pools_from_jax(pools, cfg: ModelConfig, device=None
                   ) -> Dict[str, torch.Tensor]:
    """The reference's paged pools (per-group pytrees whose leaves,
    already numpy, are named ``"pk","pv"[,"pk_s","pv_s"]`` for global
    layers, ``"lk","lv"`` for local ones, and ``"h","conv"`` /
    ``"state","shift"`` for the recurrent layers' slot slabs; an
    enc-dec decoder layer's are ``{"self": ..., "cross": {"ck","cv"}}``)
    as the port's pool stacks under the same names, each layer at its
    index in its class (the cross pools: every decoder layer)."""
    check_supported(cfg)
    dev = resolve_device(device)
    stacks: Dict[str, list] = {}

    def add(tree, r):
        for name, x in tree.items():
            if isinstance(x, dict):
                add(x, r)
            else:
                stacks.setdefault(name, []).append(np.asarray(x)[r])

    for group, b, r in _unstack_layers(pools, cfg):
        add(group[b], r)
    return {name: _tensor(np.stack(xs), dev) for name, xs in stacks.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device=None) -> Dict[str, Any]:
    """The reference's (numpy-leaved) params as the port's tree, with
    the untied ``lm_head``, a stub frontend's ``frontend_proj``
    (``{"w","b"}``) and an enc-dec model's ``encoder`` (its layers
    unstacked from the one ``(BIDIR,)`` group; the decoder layers carry
    their ``"norm_cross"``, ``"cross"`` leaves) where the reference's
    tree has them."""
    check_supported(cfg)
    dev = resolve_device(device)

    def leaf(x):
        return _tensor(x, dev)

    def layers(groups, layer_groups=None):
        return [_map(group[b], lambda x, r=r: leaf(np.asarray(x)[r]))
                for group, b, r in _unstack_layers(groups, cfg,
                                                   layer_groups)]

    out = {"embed": _map(tree["embed"], leaf),
           "final_norm": _map(tree["final_norm"], leaf),
           "layers": layers(tree["groups"])}
    for name in ("lm_head", "frontend_proj"):
        if name in tree:
            out[name] = _map(tree[name], leaf)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": layers(enc["groups"], [((BIDIR,), cfg.n_enc_layers)]),
            "final_norm": _map(enc["final_norm"], leaf)}
    return out
