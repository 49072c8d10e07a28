"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule (the port of ``repro/optim/adamw.py``).

The state mirrors the parameter tree with float32 moments, and every
rounding point is the reference's: gradients are clipped in float32,
the moments update in float32, and the new parameter is computed in
float32 and cast to the parameter's dtype.  Plain PyTorch: the
reference's update is plain XLA, not a kernel.

Two differences, both for memory at full width: the update is made in
place (parameters and moments are overwritten; the reference returns new
trees), and it goes leaf by leaf once the global norm is known, so only
one leaf's float32 temporaries exist at a time (the reference builds a
float32 copy of the whole gradient tree).

:func:`update_leaves` is the update on lists of leaves and a given
norm: the sharded train step runs it on each device's parts with the
norm of the whole placed gradient (``Placed.global_norms``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

Tensor = torch.Tensor
PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor          # int32 scalar, on the host
    mu: PyTree            # float32, like params
    nu: PyTree            # float32, like params


def tree_map(fn, *trees):
    """Map ``fn`` over the leaves of nested dicts, lists and tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*out) if hasattr(t, "_fields") else type(t)(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def init_state(params: PyTree) -> AdamWState:
    """Zero float32 moments like ``params``, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(cfg: AdamWConfig, step) -> Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def sum_squares(leaves) -> Tensor:
    """The float32 sum over ``leaves`` of each leaf's sum of squares."""
    sq = [torch.linalg.vector_norm(leaf, dtype=torch.float32).square()
          for leaf in leaves]
    return torch.stack(sq).sum()


def global_norm(tree: PyTree) -> Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of
    squares."""
    return torch.sqrt(sum_squares(tree_leaves(tree)))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, Tensor]:
    """A float32 copy of ``grads`` scaled to global norm ``max_norm`` at
    most, and the norm before clipping.  :func:`apply_updates` clips
    leaf by leaf instead and never holds this copy."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def update_leaves(params: list, grads: list, mu: list, nu: list,
                  step: Tensor, norm: Tensor, cfg: AdamWConfig) -> None:
    """One AdamW update of the leaves ``params`` and moments ``mu``,
    ``nu`` in place, from ``grads`` clipped by the global norm ``norm``;
    ``step`` is the new step count."""
    lr = float(cosine_lr(cfg, step))
    stepf = step.to(torch.float32)
    bc1 = float(1 - torch.tensor(cfg.b1, dtype=torch.float32) ** stepf)
    bc2 = float(1 - torch.tensor(cfg.b2, dtype=torch.float32) ** stepf)
    scale = _clip_scale(norm, cfg.grad_clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    for p, g, m, v in zip(params, grads, mu, nu, strict=True):
        g32 = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(b1).add_(g32, alpha=1 - b1)
        v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
        del g32
        u = m / bc1
        u.div_((v / bc2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        u.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(u.mul_(lr)))


@torch.no_grad()
def apply_updates(params: PyTree, grads: PyTree, state: AdamWState,
                  cfg: AdamWConfig) -> Tuple[PyTree, AdamWState, Dict]:
    """One AdamW step in place (module doc).  Returns the (same)
    parameter tree, the new state and ``{"grad_norm", "lr"}``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    update_leaves(tree_leaves(params), tree_leaves(grads),
                  tree_leaves(state.mu), tree_leaves(state.nu), step, gnorm,
                  cfg)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": cosine_lr(cfg, step)}
