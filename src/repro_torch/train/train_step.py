"""The train step: gradient accumulation over microbatches and AdamW (the
port of ``repro/train/train_step.py``).

``make_train_step(cfg, mesh, ...)`` returns ``train_step(params,
opt_state, batch) -> (params, opt_state, metrics)``.  Gradients come
from autograd over :func:`repro_torch.models.forward_train`; on the card
every linear and the LM head run K1 forward and backward, and MoE
experts run K4 forward, K4 for dX and K5 for dW.  The parameters and
moments are updated in place (``repro_torch.optim.adamw``), so the
returned tree is the one passed in.

On a mesh the parameters and moments are ``Placed`` trees in the FSDP x
TP layout (``place_train``, ``opt_state_specs``) and the batch is whole:
each microbatch (``accum_steps`` splits the global batch first, as the
reference's scan does) is split over the data axis by ``batch_specs``.
Autograd through the FSDP gather gives each part its data replicas'
summed gradient (the reduce-scatter), and the microbatches' gradients
are summed in float32 buffers of the shards' shapes.  Before the update
every part that several devices hold gets the sum of their gradients
(``reduce_replicas``), so its copies stay bitwise equal; AdamW then runs
on each device's parts, clipped by the norm of the whole placed
gradient (``Placed.global_norms``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import Placed, reduce_replicas
from repro_torch.models import check_supported, forward_train
from repro_torch.models.moe import set_expert_backend
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map

Tensor = torch.Tensor
PyTree = Any


def loss_and_grads(params: PyTree, cfg: ModelConfig,
                   batch: Dict[str, Tensor], *, remat: str = "full",
                   mesh=None) -> Tuple[Tensor, Dict[str, Tensor], PyTree]:
    """``(loss, metrics, grads)`` of :func:`forward_train` on ``batch``;
    ``grads`` has the tree and dtypes of ``params``.  On a mesh
    ``params`` is ``Placed`` and so are ``grads``: each device's
    gradient of its own parts, before :func:`reduce_replicas`."""
    placed = isinstance(params, Placed)
    coords = params.mesh.coords() if placed else [None]
    trees = [params.shards[c] for c in coords] if placed else [params]
    leaves: List[Tensor] = [t for tree in trees for t in tree_leaves(tree)]
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = forward_train(params, cfg, batch, remat=remat,
                                      mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    out = [tree_map(lambda _: next(it), tree) for tree in trees]
    if placed:
        shards = np.empty(params.shards.shape, dtype=object)
        for c, tree in zip(coords, out):
            shards[c] = tree
        out = [Placed(params.mesh, params.specs, shards)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            out[0])


def _split_microbatches(batch: Dict[str, Tensor], accum: int):
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         "microbatches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def _apply_updates_placed(params: Placed, grads: Placed,
                          state: adamw.AdamWState, cfg: adamw.AdamWConfig
                          ) -> Tuple[Placed, adamw.AdamWState, Dict]:
    """:func:`~repro_torch.optim.adamw.apply_updates` on placed trees of
    one layout: every device's parts updated in place, clipped by its
    copy of the global norm; the metrics carry the first device's."""
    step = state.step + 1
    norms = grads.global_norms()
    for c, norm in zip(params.mesh.coords(), norms):
        adamw.update_leaves(params.leaves(c), grads.leaves(c),
                            state.mu.leaves(c), state.nu.leaves(c), step,
                            norm, cfg)
    return params, adamw.AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": norms[0], "lr": adamw.cosine_lr(cfg, step)}


def make_train_step(cfg: ModelConfig, mesh=None, *,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    accum_steps: int = 1, remat: str = "full",
                    grad_compression: Optional[str] = None,
                    shard_grads: bool = False,
                    expert_backend: Optional[str] = None):
    """Build ``train_step(params, opt_state, batch)``.

    ``accum_steps`` > 1 splits the batch into that many microbatches and
    sums their gradients in float32 before dividing, as the reference's
    scan does; ``grad_compression="bf16"`` rounds the gradients to
    bfloat16 before the update.  With ``mesh`` (module doc) a (D, M)
    step with ``accum_steps=A`` computes what the meshless step with
    ``A * D`` computes, where routing does not depend on the split.
    ``shard_grads`` is accepted for the reference's signature and
    selects nothing: there it adds GSPMD layout hints, which leave the
    values as they are, and the port always accumulates in the shards'
    layout."""
    check_supported(cfg)
    if expert_backend is not None:
        set_expert_backend(expert_backend)
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"grad_compression {grad_compression!r} not in "
                         "(None, 'bf16')")
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def add_into(acc, g) -> None:
        for a, b in zip(tree_leaves(acc), tree_leaves(g)):
            a.add_(b.float())

    def f32_zeros(tree):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), tree)

    def mesh_grads(params: Placed, batch):
        """Loss and the summed gradients of the microbatches, in the
        parameters' layout, each part's copies reduced."""
        acc, loss = None, 0.0
        for mb in _split_microbatches(batch, accum_steps):
            mb_loss, metrics, g = loss_and_grads(params, cfg, mb,
                                                 remat=remat, mesh=mesh)
            if accum_steps == 1:
                acc = g
            elif acc is None:
                acc = g.map(lambda t: t.to(torch.float32, copy=True))
            else:
                for c in mesh.coords():
                    add_into(acc.shards[c], g.shards[c])
            del g
            loss = loss + mb_loss
        grads = reduce_replicas(acc)
        if accum_steps > 1:
            grads = grads.map(lambda t: t / accum_steps)
            metrics = {"loss": loss / accum_steps}
        return grads, metrics

    def train_step(params: PyTree, opt_state: adamw.AdamWState,
                   batch: Dict[str, Tensor]
                   ) -> Tuple[PyTree, adamw.AdamWState, Dict[str, Tensor]]:
        if mesh is not None:
            grads, metrics = mesh_grads(params, batch)
            leaves = [t for c in mesh.coords()
                      for t in tree_leaves(grads.shards[c])]
        elif accum_steps == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                                  remat=remat)
            leaves = tree_leaves(grads)
        else:
            grads = f32_zeros(params)
            loss = 0.0
            for mb in _split_microbatches(batch, accum_steps):
                mb_loss, _, g = loss_and_grads(params, cfg, mb, remat=remat)
                add_into(grads, g)
                del g
                loss = loss + mb_loss
            leaves = tree_leaves(grads)
            for a in leaves:
                a.div_(accum_steps)
            metrics = {"loss": loss / accum_steps}
        if grad_compression == "bf16":
            for g in leaves:
                g.copy_(g.to(torch.bfloat16))
        if mesh is not None:
            params, opt_state, opt_metrics = _apply_updates_placed(
                params, grads, opt_state, opt_cfg)
        else:
            params, opt_state, opt_metrics = adamw.apply_updates(
                params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
