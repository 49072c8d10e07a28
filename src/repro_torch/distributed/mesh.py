"""The port's device mesh and partition specs: the counterparts of
``jax.sharding.Mesh`` and ``jax.sharding.PartitionSpec``.

One Python process drives every device of a mesh (a single controller,
as the reference's ``Mesh`` is): a sharded tensor is one tensor per
device, each its own allocation, and the collectives of
:mod:`repro_torch.distributed.collectives` combine them in a fixed rank
order.  A device may repeat: ``[cpu] * 8`` is an 8-device CPU mesh and
``[cuda:0] * 4`` a virtual 4-device mesh on one card, whose shards are
still separate tensors, so a placement fault cannot hide behind a view.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.collectives import all_gather


class P(tuple):
    """A partition spec: one entry a tensor dimension, each ``None``
    (whole), a mesh axis name, or a tuple of names (the dimension split
    over their product, the first name outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _device_array(devices) -> np.ndarray:
    arr = np.asarray(devices, dtype=object)
    out = np.empty(arr.shape, dtype=object)
    for idx in np.ndindex(arr.shape):
        out[idx] = torch.device(arr[idx])
    return out


class Mesh:
    """Devices laid out on named axes.  ``devices`` is an array (any
    nesting numpy accepts) of ``torch.device`` or device strings whose
    rank equals ``len(axis_names)``.  ``devices=None`` takes every CUDA
    device there is as a ``(1, n)`` mesh and raises when there is none;
    the CPU is used only when asked for."""

    def __init__(self, devices=None,
                 axis_names: Sequence[str] = ("data", "model")):
        axis_names = tuple(axis_names)
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("no CUDA device is available; pass the "
                                   "devices (e.g. ['cpu'] * n) to mesh the "
                                   "CPU")
            devices = np.asarray([torch.device("cuda", i) for i in range(n)],
                                 dtype=object).reshape(
                (1,) * (len(axis_names) - 1) + (n,))
        self.devices = _device_array(devices)
        if self.devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {self.devices.ndim} for axes "
                             f"{axis_names}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def coords(self):
        """Every device coordinate, in row-major order."""
        return list(np.ndindex(self.devices.shape))

    def model_row(self, axis: str = "model", at=None) -> list:
        """The coordinates along ``axis`` with every other axis at its
        value in ``at`` (default 0): the shards that one replica of a
        model-parallel program runs on."""
        base = tuple(at) if at is not None else (0,) * self.devices.ndim
        if axis not in self.axis_names:
            return [base]
        k = self.axis_names.index(axis)
        return [base[:k] + (r,) + base[k + 1:]
                for r in range(self.shape[axis])]

    def model_devices(self, axis: str = "model", at=None) -> list:
        return [self.devices[c] for c in self.model_row(axis, at)]

    def replicas(self, axis: str = "model") -> list:
        """The first coordinate of every model row, in row-major order of
        the other axes (for ``("data", "model")``: by data index)."""
        if axis not in self.axis_names:
            return self.coords()
        k = self.axis_names.index(axis)
        return [c for c in self.coords() if c[k] == 0]

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def virtual_mesh(shape: Sequence[int], device="cuda:0",
                 axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh of ``shape`` whose every position is ``device``: a virtual
    mesh, e.g. ``(1, 4)`` shards on one card or ``(2, 2)`` on the CPU."""
    devices = np.empty(tuple(shape), dtype=object)
    devices.fill(torch.device(device))
    return Mesh(devices, axis_names)


def axis_index(mesh: Mesh, coord: Tuple[int, ...], axes) -> Tuple[int, int]:
    """``(index, count)`` of device ``coord`` along the axis product
    ``axes`` (a name or a tuple of names, the first outermost)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    idx, count = 0, 1
    for a in axes:
        n = mesh.shape[a]
        idx = idx * n + coord[mesh.axis_names.index(a)]
        count *= n
    return idx, count


def shard_slices(shape: Sequence[int], spec, mesh: Mesh,
                 coord: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slices of a tensor of ``shape`` that device ``coord`` holds
    under ``spec``."""
    out = []
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(slice(None))
            continue
        idx, count = axis_index(mesh, coord, entry)
        if dim % count:
            raise ValueError(f"dimension {dim} does not split over {entry} "
                             f"({count} devices)")
        size = dim // count
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def local_shape(shape: Sequence[int], spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape every device holds of a tensor of ``shape`` under
    ``spec``."""
    coord = (0,) * mesh.devices.ndim
    return tuple(len(range(*s.indices(d)))
                 for s, d in zip(shard_slices(shape, spec, mesh, coord),
                                 shape))


def own_copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` copied into a fresh contiguous allocation on ``device``
    (never a view, even where ``t`` already lives there)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    return out.copy_(t)


@dataclasses.dataclass
class Sharded:
    """A logical tensor of ``shape`` held by the ``model`` row of
    ``mesh`` as one tensor a rank, laid out by ``spec`` (whose only
    axis, in serving, is ``"model"``): what a ``NamedSharding``-placed
    array is to the reference's kernels and caches."""
    shards: List[torch.Tensor]
    spec: P
    shape: Tuple[int, ...]
    mesh: Mesh

    @classmethod
    def of(cls, t: torch.Tensor, spec, mesh: Mesh) -> "Sharded":
        """``t`` cut by ``spec`` over ``mesh``'s model row, one own
        allocation a rank."""
        return cls([own_copy(t[shard_slices(t.shape, spec, mesh, c)],
                             mesh.devices[c]) for c in mesh.model_row()],
                   P(*spec), tuple(t.shape), mesh)

    @classmethod
    def zeros(cls, shape, dtype, spec, mesh: Mesh) -> "Sharded":
        loc = local_shape(shape, spec, mesh)
        return cls([torch.zeros(loc, dtype=dtype, device=d)
                    for d in mesh.model_devices()], P(*spec), tuple(shape),
                   mesh)

    def part(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s part of ``t``, a tensor laid out like this one
        (dimensions this one splits of this one's sizes), as a view."""
        coord = self.mesh.model_row()[rank]
        return t[shard_slices(t.shape, self.spec, self.mesh, coord)]

    def copy_(self, t: torch.Tensor) -> None:
        """Write the whole tensor ``t`` into every rank's part of this
        one, in place (each rank its slices of ``t``; a replicated rank
        all of it)."""
        for r, s in enumerate(self.shards):
            s.copy_(self.part(t, r))

    def gather(self) -> torch.Tensor:
        """The whole tensor on rank 0's device."""
        for dim, entry in enumerate(self.spec):
            if entry is not None:
                return all_gather(self.shards, dim)[0]
        return self.shards[0]

    def __getitem__(self, idx) -> "Sharded":
        """A basic index applied to every shard; it may not cut a
        dimension the spec splits.  Integer indices drop their
        dimension from the spec."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        entries = tuple(self.spec) + (None,) * (len(self.shape)
                                                - len(self.spec))
        for i, entry in zip(idx, entries):
            if entry is not None and i != slice(None):
                raise IndexError(f"index {i} cuts a dimension split over "
                                 f"{entry}")
        shape = tuple(torch.empty(self.shape, device="meta")[idx].shape)
        spec = [e for d, e in enumerate(entries)
                if not (d < len(idx) and isinstance(idx[d], int))]
        while spec and spec[-1] is None:
            spec.pop()
        return Sharded([s[idx] for s in self.shards], P(*spec), shape,
                       self.mesh)

    def nbytes(self, unique: bool = False) -> List[int]:
        """Bytes each rank holds; with ``unique``, of the part it is the
        first holder of (a replicated tensor counts on rank 0 only), so
        the ranks' counts sum to the whole tensor's bytes."""
        split = any(e is not None for e in self.spec)
        return [s.numel() * s.element_size() if split or r == 0 or not unique
                else 0 for r, s in enumerate(self.shards)]
