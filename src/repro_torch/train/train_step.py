"""The train step: gradient accumulation over microbatches and AdamW (the
single-device port of ``repro/train/train_step.py``).

``make_train_step(cfg, ...)`` returns ``train_step(params, opt_state,
batch) -> (params, opt_state, metrics)``.  Gradients come from autograd
over :func:`repro_torch.models.forward_train`; on the card every linear
and the LM head run K1 forward and backward, and MoE experts run K4
forward, K4 for dX and K5 for dW.  The parameters and moments are
updated in place (``repro_torch.optim.adamw``), so the returned tree is
the one passed in.  Meshes, sharded gradients and expert backends other
than ``"kernel"`` belong to the distributed slice and raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import check_supported, forward_train
from repro_torch.models.moe import set_expert_backend
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map

Tensor = torch.Tensor
PyTree = Any


def loss_and_grads(params: PyTree, cfg: ModelConfig,
                   batch: Dict[str, Tensor], *, remat: str = "full"
                   ) -> Tuple[Tensor, Dict[str, Tensor], PyTree]:
    """``(loss, metrics, grads)`` of :func:`forward_train` on ``batch``;
    ``grads`` has the tree and dtypes of ``params``."""
    leaves: List[Tensor] = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = forward_train(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def _split_microbatches(batch: Dict[str, Tensor], accum: int):
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         "microbatches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


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
    bfloat16 before the update."""
    if mesh is not None or shard_grads:
        raise NotImplementedError(
            "sharded training is the distributed slice of the port "
            "(ROADMAP.md)")
    check_supported(cfg)
    if expert_backend is not None:
        set_expert_backend(expert_backend)
    if grad_compression not in (None, "bf16"):
        raise ValueError(f"grad_compression {grad_compression!r} not in "
                         "(None, 'bf16')")
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params: PyTree, opt_state: adamw.AdamWState,
                   batch: Dict[str, Tensor]
                   ) -> Tuple[PyTree, adamw.AdamWState, Dict[str, Tensor]]:
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch,
                                                  remat=remat)
        else:
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            loss = 0.0
            for mb in _split_microbatches(batch, accum_steps):
                mb_loss, _, g = loss_and_grads(params, cfg, mb, remat=remat)
                for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(b.float())
                del g
                loss = loss + mb_loss
            for a in tree_leaves(grads):
                a.div_(accum_steps)
            loss = loss / accum_steps
            metrics = {"loss": loss}
        if grad_compression == "bf16":
            for g in tree_leaves(grads):
                g.copy_(g.to(torch.bfloat16))
        params, opt_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
