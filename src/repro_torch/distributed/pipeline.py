"""GPipe pipeline parallelism over a mesh axis (the port of
``repro/distributed/pipeline.py``), on one controller.

Stage ``s`` holds its parameters on the device at index ``s`` of
``axis`` (every other axis at 0).  At each of ``n_micro + n_stages - 1``
ticks every stage applies ``stage_fn`` to its input (stage 0 injects the
next microbatch, the others take what the previous stage handed on),
and the outputs move one stage down through :func:`~repro_torch.
distributed.collectives.ppermute`.  The last stage records its output
at slot ``t - (n_stages - 1)``; at the end the records go to every stage
(an :func:`all_reduce_sum` of the last stage's records and the others'
zeros, the reference's ``psum``).  Bubble fraction = (S - 1) / (M + S - 1).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from repro_torch.distributed.collectives import all_reduce_sum, ppermute
from repro_torch.distributed.mesh import own_copy

PyTree = Any


def schedule_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble: idle slots / total slots."""
    total = n_micro + n_stages - 1
    return (n_stages - 1) / total


def _stage_leaves(tree: PyTree, s: int, device) -> PyTree:
    if isinstance(tree, dict):
        return {k: _stage_leaves(v, s, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_leaves(v, s, device) for v in tree)
    return own_copy(tree[s], device)


def pipeline_apply(stage_fn: Callable, stage_params: PyTree,
                   x_micro: torch.Tensor, mesh, axis: str = "pod"
                   ) -> List[torch.Tensor]:
    """Run ``stage_fn(params_s, x)`` as a pipeline over ``axis``.

    ``stage_params`` leaves are ``(n_stages, ...)``: stage ``s`` gets its
    slice on its device; ``x_micro`` is ``(n_micro, mb, ...)``.  Returns
    the last stage's ``(n_micro, mb, ...)`` outputs, one tensor a stage
    on that stage's device (the reference's replicated result)."""
    devices = mesh.model_devices(axis)
    n_stages = len(devices)
    n_micro = x_micro.shape[0]
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    params = [_stage_leaves(stage_params, s, d) for s, d in enumerate(devices)]
    xs = [x_micro.to(d) for d in devices]
    recv = [torch.zeros_like(x[0]) for x in xs]
    outs = [torch.zeros_like(x) for x in xs]
    for t in range(n_micro + n_stages - 1):
        inject = xs[0][min(t, n_micro - 1)]
        step = [stage_fn(p, inject if s == 0 else recv[s])
                for s, p in enumerate(params)]
        slot = t - (n_stages - 1)
        if slot >= 0:
            outs[-1] = torch.cat([outs[-1][:slot], step[-1][None],
                                  outs[-1][slot + 1:]])
        recv = ppermute(step, perm)
    return all_reduce_sum(outs)
