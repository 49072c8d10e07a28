"""Collectives over per-shard tensors, in a fixed rank order.

The port runs a mesh from one controller (:mod:`~repro_torch.
distributed.mesh`): a sharded value is a list with one tensor a rank of
a group, each on its rank's device.  A group is the shards of one mesh
axis with the others fixed, in rank order: the ``model`` row of a data
replica (tensor and expert parallelism), or the ``data`` column of one
model rank (FSDP's parameter gather, whose backward under autograd is
the reduce-scatter of the gradients; the data-parallel loss; a stage
axis for the pipeline).  These are the only places where ranks exchange
data, so a later multi-process backend can put process groups behind
the same four calls.  Each returns one tensor a rank, on that rank's
device (the input's); on a virtual mesh, whose ranks share a device,
that is one tensor.  All four are made of differentiable torch ops.
Each call is a ``torch.profiler`` range named ``collective::<call>``,
so a profile shows the device time the exchanges take.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch.profiler import record_function

Tensor = torch.Tensor


def _to_ranks(t: Tensor, like: List[Tensor]) -> List[Tensor]:
    return [t.to(x.device) for x in like]


def all_reduce_sum(xs: List[Tensor]) -> List[Tensor]:
    """The elementwise sum of every rank's tensor, accumulated in float32
    in rank order and rounded once to the inputs' dtype."""
    with record_function("collective::all_reduce_sum"):
        home = xs[0].device
        acc = xs[0].float()
        for x in xs[1:]:
            acc = acc + x.to(home).float()
        return _to_ranks(acc.to(xs[0].dtype), xs)


def all_gather(xs: List[Tensor], dim: int) -> List[Tensor]:
    """Every rank's tensor concatenated along ``dim`` in rank order."""
    with record_function("collective::all_gather"):
        home = xs[0].device
        return _to_ranks(torch.cat([x.to(home) for x in xs], dim=dim), xs)


def all_to_all(xs: List[Tensor], split_dim: int,
               concat_dim: int) -> List[Tensor]:
    """The tiled all-to-all of ``jax.lax.all_to_all(tiled=True)``: rank
    ``i`` splits its tensor along ``split_dim`` into one chunk a rank,
    and rank ``j`` concatenates chunk ``j`` of every rank along
    ``concat_dim``, in rank order."""
    n = len(xs)
    chunks = [torch.chunk(x, n, dim=split_dim) for x in xs]
    if any(len(c) != n or c[0].shape != c[-1].shape for c in chunks):
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(xs[0].shape)} does not split {n} ways")
    with record_function("collective::all_to_all"):
        return [torch.cat([chunks[i][j].to(xs[j].device) for i in range(n)],
                          dim=concat_dim) for j in range(n)]


def ppermute(xs: List[Tensor], perm: Sequence[Tuple[int, int]]
             ) -> List[Tensor]:
    """``jax.lax.ppermute``: rank ``j`` receives rank ``i``'s tensor for
    each pair ``(i, j)`` of ``perm``, and a rank that receives nothing
    gets zeros of its own tensor's shape."""
    src = {j: i for i, j in perm}
    with record_function("collective::ppermute"):
        return [xs[src[j]].to(x.device) if j in src else torch.zeros_like(x)
                for j, x in enumerate(xs)]
