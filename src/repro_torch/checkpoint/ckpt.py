"""Checkpoints of the training state (the single-device part of
``repro/checkpoint/ckpt.py``, in its layout).

``<root>/step_<N>/`` holds ``shards-0.npz`` (every leaf, keyed by its
path in the tree) and ``manifest.json`` (step, leaf shapes and dtypes,
``extra``).  Both are written to a temporary name and renamed into
place, the manifest last, so a directory with a manifest is complete.
numpy has no bfloat16, so bfloat16 leaves are stored as their uint16 bit
patterns with ``"bfloat16"`` in the manifest, and come back bit for bit.
:func:`save_step` keeps the newest ``keep`` steps.

A tree placed on a mesh (a ``Placed`` subtree: sharded parameters or
moments) is saved as its whole leaves (``unshard_tree``), in the
single-device layout, so one file restores onto any mesh: :func:`restore`
with ``mesh`` and ``specs`` places the leaves by the specs of the mesh
it restores onto (elastic resharding; the reference reassembles each
leaf and re-places it the same way).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

PyTree = Any

_SAFE = re.compile(r"[^\w.\-]")
SHARDS = "shards-0.npz"


def _whole(tree: PyTree, meta: bool) -> PyTree:
    """``tree`` with each ``Placed`` subtree replaced by its whole leaves
    (on the CPU), or, with ``meta``, by meta tensors of their shapes."""
    from repro_torch.distributed.mesh import P
    from repro_torch.distributed.sharding import (_axes_size, Placed,
                                                  tree_map, unshard_tree)
    if isinstance(tree, Placed):
        if not meta:
            return unshard_tree(tree.shards, tree.specs, tree.mesh)

        def proto(spec, t):
            shape = list(t.shape)
            for i, entry in enumerate(P(*spec)):
                if entry is not None:
                    shape[i] *= _axes_size(tree.mesh, entry)
            return torch.empty(shape, dtype=t.dtype, device="meta")
        return tree_map(proto, tree.specs,
                        tree.shards[(0,) * tree.mesh.devices.ndim])
    if isinstance(tree, dict):
        return {k: _whole(v, meta) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(v, meta) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v, meta) for v in tree)
    return tree


def _place(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """``tree`` on ``mesh``: each dict or list subtree of ``specs`` (a
    tree of specs) becomes a ``Placed`` of ``tree``'s matching subtree;
    a spec standing alone in a tuple (the optimizer's step) leaves its
    leaf whole, replicated, where it is."""
    from repro_torch.distributed.mesh import P
    from repro_torch.distributed.sharding import Placed, shard_tree
    if isinstance(specs, (dict, list)):
        return Placed(mesh, specs, shard_tree(tree, specs, mesh))
    if isinstance(specs, tuple) and not isinstance(specs, P):
        out = [_place(t, s, mesh) for t, s in zip(tree, specs)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return tree


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, Any]:
    """Leaves by path: dict keys, list/tuple indices and named-tuple
    fields, joined with ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten(like: PyTree, leaves: Dict[str, Any], prefix: str = ""):
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, key(f))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves, key(i))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def save(path: str, step: int, tree: PyTree, *,
         extra: Optional[dict] = None) -> None:
    """Write ``<path>/shards-0.npz`` and ``<path>/manifest.json``, each
    atomically, the manifest last."""
    os.makedirs(path, exist_ok=True)
    arrays, leaves = {}, {}
    for k, v in _flatten(_whole(tree, meta=False)).items():
        arr, dtype = _to_numpy(v)
        arrays[_SAFE.sub("__", k)] = arr
        leaves[k] = {"shape": list(arr.shape), "dtype": dtype}
    manifest = {"step": step, "process_index": 0, "process_count": 1,
                "leaves": leaves, "extra": extra or {}}
    tmp_npz = os.path.join(path, ".tmp-" + SHARDS)
    np.savez(tmp_npz, **arrays)
    os.replace(tmp_npz, os.path.join(path, SHARDS))
    tmp_man = os.path.join(path, ".tmp-manifest.json")
    with open(tmp_man, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp_man, os.path.join(path, "manifest.json"))


def latest_step_dir(root: str) -> Optional[str]:
    """The ``step_<N>`` directory under ``root`` with the largest N and a
    manifest, or None."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.startswith("step_")
             and os.path.exists(os.path.join(root, d, "manifest.json"))]
    if not steps:
        return None
    best = max(steps, key=lambda d: int(d.split("_")[1]))
    return os.path.join(root, best)


def restore(path: str, like: PyTree, *, mesh=None, specs: PyTree = None
            ) -> Tuple[int, PyTree]:
    """``(step, tree)`` from ``path``; ``like`` gives the tree's
    structure, and each leaf's shape, dtype and device (a ``Placed``
    subtree of ``like``: its whole shapes, on the CPU).  With ``mesh``
    and ``specs`` (a tree of specs matching ``like``, e.g. ``(param
    specs, opt_state_specs(...))``) the tree is placed on ``mesh``
    (:func:`_place`), whatever mesh wrote it."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = _whole(like, meta=True)
    restored = {}
    with np.load(os.path.join(path, SHARDS)) as data:
        for k, proto in _flatten(like).items():
            arr = data[_SAFE.sub("__", k)]
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(f"{k}: checkpoint {arr.shape} vs model "
                                 f"{tuple(proto.shape)}")
            if manifest["leaves"][k]["dtype"] == "bfloat16":
                t = torch.from_numpy(np.array(arr).view(np.int16)).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            dev = "cpu" if proto.device.type == "meta" else proto.device
            restored[k] = t.to(device=dev, dtype=proto.dtype)
    tree = _unflatten(like, restored)
    if mesh is not None and specs is not None:
        tree = _place(tree, specs, mesh)
    return manifest["step"], tree


def save_step(root: str, step: int, tree: PyTree, *, keep: int = 3,
              extra: Optional[dict] = None) -> str:
    """Save under ``<root>/step_<step>`` and delete all but the newest
    ``keep`` step directories."""
    path = os.path.join(root, f"step_{step}")
    save(path, step, tree, extra=extra)
    steps = sorted((d for d in os.listdir(root) if d.startswith("step_")),
                   key=lambda d: int(d.split("_")[1]))
    for old in steps[:-keep]:
        full = os.path.join(root, old)
        for f in os.listdir(full):
            os.remove(os.path.join(full, f))
        os.rmdir(full)
    return path
